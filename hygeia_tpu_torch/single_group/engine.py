"""Single-group online combined inference: discrete change-point SMC,
adaptive-lag marginal smoothing and online score-based parameter
estimation, one site at a time.

Counterpart of hygeia_tpu/single_group/engine.py, batched over U units
written out as a leading axis (the JAX package vmaps them). The site loop
is a Python ``for`` that never waits for the device:

* what JAX traced as a branch on the step index (the particle-count
  schedule, ``t % steps_per_update == 0``, the last step) is a Python
  branch here; the tables are rebuilt only on update steps;
* what depends on the data (the resampler's fallback, the free smoothing
  slot, the oldest pending entry, which entries finalise) stays a tensor
  under ``torch.where`` and indexed writes, with no ``.item()``, no
  boolean-mask indexing and no ``nonzero``.

Layout of the N particle slots at step t (as in JAX): continuations
[0, m_t), the R fresh change-point particles [m_t, m_t + R), dead slots
after. The one-hot matmul lookups of the TPU version are gathers here.

Finalised regime estimates go straight into a preallocated (U, T + 1, R)
float32 output at their own time (row T is a sentinel that absorbs the
writes of entries that do not finalise); the JAX package's ring buffer and
per-step emitted rows give the same values and ``regime_valid``.

Every site calls the optimal resampler (ops/cuda_resampling) in float32 on
the previous weights, M_cap = N - R offspring: the CUDA kernel for CUDA
tensors, the plain version for CPU tensors.

Per-unit inputs (the blocked theta stage and the multi-chromosome batch):
an emission table per unit (U, T, R), a warm ADAM state per unit
(``adam_init``), and an effective length per unit (``t_limit``): at
t >= t_limit[u] unit u's whole state freezes and adds nothing to logZ, and
its pending smoothing entries finalise at its own t_limit[u] - 1, so its
first t_limit[u] rows are those of a run of that length.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from hygeia_tpu_torch.ops.cuda_resampling import optimal_resampling
from hygeia_tpu_torch.single_group.model import SingleGroupModel, build_tables

_NEG_INF = float("-inf")
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8
_CHECKPOINT_VERSION = 2  # of the .npz the chunked engine writes (2: adam_iter per unit)
# State that a unit past its t_limit keeps as it was.
_FROZEN = ("d", "r", "w", "psi", "psi_time", "psi_valid", "spill", "phi", "theta", "grad_prev",
           "adam_m", "adam_v", "score", "adam_iter")


class EngineConfig(NamedTuple):
    n_particles_max: int = 250  # N_max (CLI --n_particles default)
    epsilon: float = 0.01  # smoothing finalisation threshold
    smoothing_window: int = 128  # S_cap: pending entries; max lag
    estimate_regimes: bool = True
    estimate_parameters: bool = False
    steps_per_update: int = 200  # --n_steps_without_parameter_update
    learning_rate_exponent: float = 0.1
    learning_rate_factor: float = 0.01
    use_adam: bool = True
    normalise_gradients: bool = False
    progress_every: int = 0  # print "step t" every N sites, 0 = off


class EngineResult(NamedTuple):
    regime_probs: torch.Tensor  # (U, T, R) float32 marginal smoothing estimates
    regime_valid: torch.Tensor  # (U, T) bool
    theta_trace: torch.Tensor  # (U, T, D): theta_init, then theta after each step
    log_normalizing_constant: torch.Tensor  # (U,)
    spill_count: torch.Tensor  # (U,) forced finalisations (full buffer or age S_cap)
    final_theta: torch.Tensor  # (U, D)
    final_score: torch.Tensor  # (U, D) filtered mean of phi at the last step
    final_opt_state: tuple  # (adam_m (U, D), adam_v (U, D), adam_iter (U,) int64)


def _grad_p_block_columns(R):
    """Static (R, R) map: colidx[r_prev, j] is the theta column of the
    P-row-gradient entry j of block r_prev (j == r_prev unused, 0)."""
    col = np.zeros((R, R), np.int64)
    for rp in range(R):
        for j in range(R):
            if j != rp:
                col[rp, j] = rp * (R - 1) + (j if j < rp else j - 1)
    return col


class _Engine:
    """The engine's resumable state (``state``, a dict of tensors and ints)
    and its per-site step."""

    def __init__(self, model: SingleGroupModel, theta_init, emissions, config: EngineConfig,
                 n_units, weight_dtype, adam_init=None, t_limit=None):
        self.model, self.config = model, config
        self.device = dev = emissions.device
        self.dtype = dtype = weight_dtype
        self.U = U = int(n_units)
        self.R = R = model.n_regimes
        self.N = N = config.n_particles_max
        self.M = N - R
        self.S = S = config.smoothing_window
        self.D = D = model.dim_theta
        self.T = T = emissions.shape[-2]
        self.n_haz = 3 if model.kappa_fixed else 4
        if self.M < 1:
            raise ValueError(f"n_particles_max={N} must exceed the {R} regimes")
        if emissions.dim() == 3 and emissions.shape[0] != U:
            raise ValueError(f"per-unit emissions {tuple(emissions.shape)} for {U} units")
        # (U, T, R); one shared table is a view of it.
        self.emissions = emissions.to(dtype).expand(U, T, R)
        self.regimes = torch.arange(R, device=dev)
        col = _grad_p_block_columns(R)
        scat = np.zeros((R, R, D))
        for r in range(R):
            for j in range(R):
                if j != r:
                    scat[r, j, col[r, j]] = 1.0
        self.scat_p = torch.as_tensor(scat, dtype=dtype, device=dev)
        self.units = torch.arange(U, device=dev)

        theta = torch.as_tensor(theta_init, dtype=dtype, device=dev)
        theta = theta.expand(U, D).clone() if theta.dim() == 1 else theta.clone()
        slot = torch.arange(N, device=dev)
        first = slot < R
        r0 = torch.where(first, slot, 0)
        w0 = torch.where(first, -math.log(float(R)) + self.emissions[:, 0, r0], _NEG_INF)
        shift0 = torch.logsumexp(w0, dim=-1)
        w0 = w0 - shift0[:, None]

        psi = torch.zeros((U, S, R, N), dtype=dtype, device=dev)
        psi[:, 0] = ((r0[None, :] == self.regimes[:, None]) & first).to(dtype)
        psi_time = torch.full((U, S), T, dtype=torch.int64, device=dev)
        psi_time[:, 0] = 0
        psi_valid = torch.zeros((U, S), dtype=torch.bool, device=dev)
        psi_valid[:, 0] = True
        out = torch.zeros((U, T + 1, R), dtype=torch.float32, device=dev)
        out_valid = torch.zeros((U, T + 1), dtype=torch.bool, device=dev)
        # The entry of time 0 may finalise at once (storeEstimates at
        # initialisation), unless it is also the last step.
        if T > 1:
            p0 = torch.exp(w0)
            means0 = psi[:, 0] @ p0[:, :, None]  # (U, R, 1)
            diff = psi[:, 0] - means0
            second0 = (diff * diff) @ p0[:, :, None]
            fin0 = (second0[..., 0] < config.epsilon).all(dim=-1)
            out[:, 0] = torch.where(fin0[:, None], means0[..., 0].float(), 0.0)
            out_valid[:, 0] = fin0
            psi_valid[:, 0] = ~fin0

        shifts = torch.zeros((U, T), dtype=dtype, device=dev)
        shifts[:, 0] = shift0
        trace = torch.empty((U, T, D), dtype=dtype, device=dev)
        trace[:, 0] = theta
        zeros_ud = torch.zeros((U, D), dtype=dtype, device=dev)
        adam_m, adam_v = zeros_ud.clone(), zeros_ud.clone()
        adam_iter = torch.zeros((U,), dtype=torch.int64, device=dev)
        if adam_init is not None:
            m0, v0, it0 = adam_init
            adam_m = torch.as_tensor(m0, dtype=dtype, device=dev).expand(U, D).clone()
            adam_v = torch.as_tensor(v0, dtype=dtype, device=dev).expand(U, D).clone()
            adam_iter = torch.as_tensor(it0, dtype=torch.int64, device=dev).expand(U).clone()
        # Units past their t_limit: the host knows when the first one stops
        # and which sites finalise a unit; the device reads row t of `live`.
        self.live = self.final_at = None
        self.t_freeze = T
        if t_limit is not None:
            lim = np.array(np.broadcast_to(np.asarray(t_limit, np.int64), (U,)))
            if lim.min() < 1 or lim.max() > T:
                raise ValueError(f"t_limit must lie in [1, {T}], got {lim.tolist()}")
            self.t_freeze = int(lim.min())
            lim_t = torch.as_tensor(lim, device=dev)
            self.live = torch.arange(T, device=dev)[:, None] < lim_t[None, :]  # (T, U)
            self.final_at = {int(t): lim_t == t + 1 for t in np.unique(lim - 1)}
        self.state = dict(
            d=torch.where(first, 1, 0).expand(U, N).clone(),
            r=r0.expand(U, N).clone(),
            w=w0.contiguous(),
            psi=psi, psi_time=psi_time, psi_valid=psi_valid,
            out=out, out_valid=out_valid,
            spill=torch.zeros((U,), dtype=torch.int64, device=dev),
            phi=torch.zeros((U, N, D), dtype=dtype, device=dev),
            theta=theta, grad_prev=zeros_ud, adam_m=adam_m, adam_v=adam_v,
            score=zeros_ud.clone(), shifts=shifts, trace=trace,
            adam_iter=adam_iter, next_t=1,
        )
        self._set_tables(build_tables(model, theta))

    def _set_tables(self, tables):
        """Keep the tables and a (U, n_haz, R * W) stack of the per-particle
        lookups (rho, exit as 0/1, grad omega[, grad kappa]) for one gather."""
        self.tables = tables
        parts = [tables.rho, tables.exit_status.to(self.dtype), tables.grad_omega_log_rho]
        if not self.model.kappa_fixed:
            parts.append(tables.grad_kappa_log_rho)
        self.haz = torch.stack(parts, dim=1).reshape(self.U, self.n_haz, -1)

    def _lookup(self, d_prev, r_prev):
        """(U, n_haz, N) table values at each particle's (sojourn, regime);
        sojourns clamp to the table depth, regimes to [0, R)."""
        W = self.model.d_max
        idx = (torch.clamp(r_prev, 0, self.R - 1) * W + torch.clamp(d_prev - 1, 0, W - 1))
        return self.haz.gather(2, idx[:, None, :].expand(-1, self.n_haz, -1))

    def step(self, t, u_sys, u_mult):
        """Advance the state from site t - 1 to site t (1 <= t < T)."""
        st, cfg = self.state, self.config
        U, R, N, M, S, D, T = self.U, self.R, self.N, self.M, self.S, self.D, self.T
        dtype, dev, model = self.dtype, self.device, self.model
        d_prev, r_prev, w_prev = st["d"], st["r"], st["w"]
        live = None
        if t >= self.t_freeze:  # some unit is past its t_limit: keep its state
            live = self.live[t]
            old = {k: st[k] for k in _FROZEN}
            for k in ("psi_time", "psi_valid", "spill"):  # updated in place below
                old[k] = st[k].clone()

        # Deterministic particle-count schedule.
        n_prev = min(R * t, N)
        m_t = min(R * (t + 1), N) - R
        at_capacity = n_prev + R > N
        n_dead = N - m_t - R

        # ---- resample (every site, f32, through the kernel on the card) ---
        res = optimal_resampling(w_prev.to(torch.float32).contiguous(), M, u_sys, u_mult)
        if at_capacity:
            top = res.top_m_indices.long()
            # The top-M fallback on a non-finite log_c keeps the M largest
            # weights as they are (not the multinomial fallback).
            n_finite = torch.isfinite(w_prev).sum(dim=-1)
            use_optimal = ((n_finite > M) & ~res.use_unbiased)[:, None]
            anc = torch.where(use_optimal, res.parent_indices.long(), top)[:, :m_t]
            anc_w = torch.where(use_optimal, res.new_log_weights.to(dtype), w_prev.gather(1, top))
            anc_w = anc_w[:, :m_t]
        else:  # growth phase: identity passthrough
            anc = torch.arange(m_t, device=dev).expand(U, m_t)
            anc_w = w_prev[:, :m_t]

        # ---- propagate and weight -------------------------------------------
        trio = self._lookup(d_prev, r_prev)  # (U, n_haz, N) at the previous particles
        trio_a = trio.gather(2, anc[:, None, :].expand(-1, self.n_haz, -1))  # at ancestors
        rho_a, exit_a = trio_a[:, 0], trio_a[:, 1] > 0.5
        d_a, r_a = d_prev.gather(1, anc), r_prev.gather(1, anc)
        fresh_r = self.regimes.expand(U, R)
        zeros_dead = torch.zeros((U, n_dead), dtype=d_prev.dtype, device=dev)
        d_new = torch.cat([d_a + 1, torch.ones_like(fresh_r), zeros_dead], dim=1)
        r_new = torch.cat([r_a, fresh_r, zeros_dead], dim=1)

        obs_t = self.emissions[:, t]  # (U, R)
        # Guard rho <= 1: near the latch rho can exceed 1 numerically.
        cont_lp = torch.where(exit_a | (rho_a > 1.0), _NEG_INF, torch.log1p(-rho_a))
        w_cont = anc_w + (cont_lp + obs_t.gather(1, r_a))

        # Fresh change points marginalise over every previous particle:
        # cp_lp[q, n] = log f((1, q) | prev n), and the backward kernels B.
        rho_p, exit_p = trio[:, 0], trio[:, 1] > 0.5
        r_idx = torch.clamp(r_prev, 0, R - 1)
        log_rho_term = torch.where(exit_p, 0.0, torch.log(rho_p))
        valid = (self.regimes[None, :, None] != r_prev[:, None, :]) & (d_prev >= model.u)[:, None, :]
        log_p_qn = self.tables.log_P.gather(1, r_idx[:, :, None].expand(-1, -1, R)).transpose(1, 2)
        cp_lp = torch.where(valid, log_rho_term[:, None, :] + log_p_qn, _NEG_INF)  # (U, R, N)
        safe_prev_w = torch.where(torch.isfinite(w_prev), w_prev, _NEG_INF)
        log_b = cp_lp + safe_prev_w[:, None, :]
        log_bz = torch.logsumexp(log_b, dim=-1, keepdim=True)  # (U, R, 1)
        w_fresh = log_bz[..., 0] + obs_t
        b = torch.where(torch.isfinite(log_bz), torch.exp(log_b - log_bz), 0.0)  # (U, R, N)

        w_new = torch.cat(
            [w_cont, w_fresh, torch.full((U, n_dead), _NEG_INF, dtype=dtype, device=dev)], dim=1
        )
        shift = torch.logsumexp(w_new, dim=-1)
        w_new = w_new - shift[:, None]
        w_self = torch.where(torch.isfinite(w_new), torch.exp(w_new), 0.0)
        st["shifts"][:, t] = shift if live is None else torch.where(live, shift, 0.0)

        # ---- adaptive-lag marginal smoothing --------------------------------
        if cfg.estimate_regimes:
            if self.final_at is None:
                final = t == T - 1
            else:
                final = self.final_at.get(t, False)
            self._smooth(t, anc, b, r_new, w_self, m_t, live, final)

        # ---- online parameter estimation ------------------------------------
        updated = False
        if cfg.estimate_parameters:
            updated = self._estimate(t, trio, trio_a, r_idx, r_a, anc, b, valid, w_self, m_t)
        st["d"], st["r"], st["w"] = d_new, r_new, w_new
        if live is not None:
            for k, v in old.items():
                keep = live.view(U, *([1] * (v.dim() - 1)))
                st[k] = torch.where(keep, st[k], v)
        if updated:
            self._set_tables(build_tables(model, st["theta"]))
        st["trace"][:, t] = st["theta"]
        st["next_t"] = t + 1
        if cfg.progress_every and t % cfg.progress_every == 0:
            print(f"single-group engine: step {t}", flush=True)

    def _mix(self, stat, anc, b, m_t, axis):
        """The statistic at t - 1 carried to the slots at t along the particle
        ``axis``: gathered at the ancestor for a continuation, averaged under
        the backward kernel B for a fresh particle, zero for a dead slot."""
        n_dead = self.N - m_t - self.R
        if axis == -1:  # (U, S, R, N)
            cont = stat.gather(3, anc[:, None, None, :].expand(*stat.shape[:3], -1))
            fresh = stat @ b.transpose(1, 2)[:, None]  # (U, S, R, R)
            dead = stat.new_zeros((*stat.shape[:3], n_dead))
        else:  # (U, N, D)
            cont = stat.gather(1, anc[:, :, None].expand(-1, -1, stat.shape[2]))
            fresh = b @ stat  # (U, R, D)
            dead = stat.new_zeros((stat.shape[0], n_dead, stat.shape[2]))
        return torch.cat([cont, fresh, dead], dim=axis)

    def _smooth(self, t, anc, b, r_new, w_self, m_t, live, final):
        """``live``: None or the (U,) units not yet past their t_limit (the
        others write only the sentinel row T). ``final``: whether every
        pending entry finalises at this site, a bool for all units or a
        (U,) mask."""
        st, U, S, T, R = self.state, self.U, self.S, self.T, self.R
        units = self.units
        psi_valid, psi_time = st["psi_valid"], st["psi_time"]
        psi_new = self._mix(st["psi"], anc, b, m_t, axis=-1)
        psi_new = torch.where(psi_valid[:, :, None, None], psi_new, 0.0)
        w_col = w_self[:, None, :, None]  # (U, 1, N, 1)

        # Insert time t into a free entry; with none free, force-finalise
        # the oldest pending entry first (a spill).
        means_pre = (psi_new @ w_col)[..., 0]  # (U, S, R)
        has_free = (~psi_valid).any(dim=-1)
        free_slot = (~psi_valid).to(torch.uint8).argmax(dim=-1)
        oldest = torch.where(psi_valid, psi_time, T + 1).argmin(dim=-1)
        ins = torch.where(has_free, free_slot, oldest)
        st["spill"] += (~has_free).to(torch.int64)
        spill_time = torch.where(has_free, T, psi_time[units, ins])  # row T: no spill
        if live is not None:
            spill_time = torch.where(live, spill_time, T)
        st["out"][units, spill_time] = means_pre[units, ins].float()
        st["out_valid"][units, spill_time] = True

        alive = torch.arange(self.N, device=self.device) < m_t + R
        test_t = ((r_new[:, None, :] == self.regimes[None, :, None]) & alive).to(self.dtype)
        psi_new[units, ins] = test_t
        psi_time[units, ins] = t
        psi_valid[units, ins] = True

        # Finalise the entries whose R variances all fall below epsilon,
        # every entry at the last step, and (counted as spills) those that
        # reached age S_cap.
        means = (psi_new @ w_col)[..., 0]
        diff = psi_new - means[..., None]
        second = ((diff * diff) @ w_col)[..., 0]
        all_below = (second < self.config.epsilon).all(dim=-1)
        if final is True:
            fin = psi_valid
        else:
            aged = psi_time <= t - S
            forced = aged & ~all_below
            if final is not False:  # the units whose t_limit ends here finalise everything
                forced = forced & ~final[:, None]
                all_below = all_below | final[:, None]
            st["spill"] += (psi_valid & forced).sum(dim=-1)
            fin = psi_valid & (all_below | aged)
        written = fin if live is None else fin & live[:, None]
        times = torch.where(written, psi_time, T)  # entries that stay pending write row T
        st["out"][units[:, None], times] = means.float()
        st["out_valid"][units[:, None], times] = True
        st["psi"], st["psi_valid"] = psi_new, psi_valid & ~fin

    def _estimate(self, t, trio, trio_a, r_idx, r_a, anc, b, valid, w_self, m_t):
        st, cfg, model = self.state, self.config, self.model
        U, R, N, D = self.U, self.R, self.N, self.D
        om_col, ka_col = R * (R - 1), R * R

        # Continuations: only the omega (and kappa) entries of the regime are
        # nonzero, -rho / (1 - rho) times the log-rho gradients; 0 on exit.
        rho_a, exit_a = trio_a[:, 0], trio_a[:, 1] > 0.5
        coef = torch.where(exit_a | (rho_a >= 1.0), 0.0, -rho_a / (1.0 - rho_a))
        g_cont = st["phi"].new_zeros((U, m_t, D))
        g_cont.scatter_(2, (om_col + r_a)[..., None], (coef * trio_a[:, 2])[..., None])
        if not model.kappa_fixed:
            g_cont.scatter_(2, (ka_col + r_a)[..., None], (coef * trio_a[:, 3])[..., None])

        # Fresh particles: the change-point density's gradient at every
        # previous particle, averaged under B. The omega entry keeps the
        # log-rho gradient even on exit; P-row entries are 1[j == q] - P[r, j].
        base = st["phi"].new_zeros((U, N, D))
        base.scatter_(2, (om_col + r_idx)[..., None], trio[:, 2, :, None])
        if not model.kappa_fixed:
            base.scatter_(2, (ka_col + r_idx)[..., None], trio[:, 3, :, None])
        rows_p = self.tables.P.gather(1, r_idx[:, :, None].expand(-1, -1, R))  # (U, N, R)
        eye = torch.eye(R, dtype=self.dtype, device=self.device)
        vals = eye[None, :, None, :] - rows_p[:, None]  # (U, Q, N, R)
        onehot_p = self.scat_p[r_idx]  # (U, N, R, D)
        g_cp = base[:, None] + torch.einsum("uqnj,unjd->uqnd", vals, onehot_p)
        g_cp = torch.where(valid[..., None], g_cp, 0.0)
        g_fresh = torch.einsum("uqn,uqnd->uqd", b, g_cp)  # (U, R, D)

        n_dead = N - m_t - R
        grad_term = torch.cat([g_cont, g_fresh, g_cont.new_zeros((U, n_dead, D))], dim=1)
        phi = self._mix(st["phi"], anc, b, m_t, axis=1) + grad_term
        score = (w_self[:, None, :] @ phi)[:, 0]  # (U, D)
        st["phi"], st["score"] = phi, score

        if t % cfg.steps_per_update != 0:
            return False
        gradient = score - st["grad_prev"]
        it = st["adam_iter"]
        it1 = (it.to(self.dtype) + 1.0)[:, None]  # (U, 1): each unit's own count
        lr = cfg.learning_rate_factor / it1**cfg.learning_rate_exponent
        if cfg.use_adam:
            m2 = _ADAM_B1 * st["adam_m"] + (1 - _ADAM_B1) * gradient
            v2 = _ADAM_B2 * st["adam_v"] + (1 - _ADAM_B2) * gradient * gradient
            delta = (lr * m2 / (torch.sqrt(v2 / (1.0 - _ADAM_B2**it1)) + _ADAM_EPS)
                     / (1.0 - _ADAM_B1**it1))
            st["adam_m"], st["adam_v"] = m2, v2
        else:
            g = gradient
            if cfg.normalise_gradients:
                g = g / torch.clamp(g.abs().sum(dim=-1, keepdim=True), min=1e-30)
            delta = lr * g
        st["theta"] = st["theta"] + delta
        st["adam_iter"] = it + 1
        st["grad_prev"] = score
        return True

    def result(self) -> EngineResult:
        st, T = self.state, self.T
        return EngineResult(
            regime_probs=st["out"][:, :T],
            regime_valid=st["out_valid"][:, :T],
            theta_trace=st["trace"],
            log_normalizing_constant=st["shifts"].sum(dim=-1),
            spill_count=st["spill"],
            final_theta=st["theta"],
            final_score=st["score"],
            final_opt_state=(st["adam_m"], st["adam_v"], st["adam_iter"]),
        )

    # ---- checkpoints -------------------------------------------------------
    def save(self, path, generator=None):
        """Write the state to ``path`` (.npz) through a temporary file."""
        arrays = {k: v.cpu().numpy() for k, v in self.state.items() if torch.is_tensor(v)}
        ints = {k: np.int64(v) for k, v in self.state.items() if not torch.is_tensor(v)}
        if generator is not None:
            arrays["generator_state"] = generator.get_state().numpy()
        tmp = str(path) + ".tmp.npz"
        np.savez(tmp, version=np.int64(_CHECKPOINT_VERSION), T=np.int64(self.T), **arrays, **ints)
        os.replace(tmp, path)

    def load(self, ck, generator=None):
        """Take the state from an opened checkpoint."""
        for k, v in self.state.items():
            if torch.is_tensor(v):
                self.state[k] = torch.as_tensor(ck[k], device=self.device)
            else:
                self.state[k] = int(ck[k])
        if generator is not None and "generator_state" in ck:
            generator.set_state(torch.as_tensor(ck["generator_state"]))
        self._set_tables(build_tables(self.model, self.state["theta"]))


def _site_uniforms(t, n_units, n_offspring, u_sys, u_mult, generator, device, shared=False):
    """(u_sys (U,), u_mult (U, M)) of site t: the injected draws when given
    (row t - 1), else fresh ones from ``generator``; with ``shared`` one
    unit's draws for every unit (those of a one-unit run on the same
    generator)."""
    if u_sys is not None:
        return u_sys[t - 1], u_mult[t - 1]
    if shared:
        us = torch.rand((1,), generator=generator, device=device)
        um = torch.rand((1, n_offspring), generator=generator, device=device)
        return us.expand(n_units).contiguous(), um.expand(n_units, n_offspring).contiguous()
    return (torch.rand((n_units,), generator=generator, device=device),
            torch.rand((n_units, n_offspring), generator=generator, device=device))


def _check_uniforms(T, U, M, u_sys, u_mult, generator, device):
    if u_sys is None and u_mult is None:
        if generator is None:
            raise ValueError("pass a torch.Generator, or u_sys and u_mult")
        return None, None
    u_sys = torch.as_tensor(u_sys, dtype=torch.float32, device=device)
    u_mult = torch.as_tensor(u_mult, dtype=torch.float32, device=device)
    if tuple(u_sys.shape) != (T - 1, U) or tuple(u_mult.shape) != (T - 1, U, M):
        raise ValueError(
            f"u_sys must be ({T - 1}, {U}) and u_mult ({T - 1}, {U}, {M}), got "
            f"{tuple(u_sys.shape)} and {tuple(u_mult.shape)}"
        )
    return u_sys.contiguous(), u_mult.contiguous()


def run_online_combined_inference(
    model: SingleGroupModel,
    theta_init,
    emissions,  # (T, R) or per unit (U, T, R) emission log-lik table on the engine's device
    config: EngineConfig,
    *,
    n_units=1,
    generator=None,
    u_sys=None,
    u_mult=None,
    shared_draws=False,
    weight_dtype=torch.float32,
    adam_init=None,
    t_limit=None,
) -> EngineResult:
    """Run the combined algorithm over the T sites for ``n_units`` units.

    theta_init: (D,) for every unit or (U, D). Randomness: the resampler's
    uniforms of site t are row t - 1 of ``u_sys`` (T-1, U) and ``u_mult``
    (T-1, U, M_cap) when given (a test passes the draws JAX derives from
    ``fold_in(key, t)``), else drawn from ``generator``: fresh ones for each
    unit, or with ``shared_draws`` the same for every unit, those a one-unit
    run on the same generator takes (JAX's batched theta stage gives every
    chromosome the same key).

    adam_init: (adam_m (U, D) or (D,), adam_v likewise, adam_iter (U,) or a
    count): the ADAM state to start from (the blocked theta stage continues
    a warmup chain's); grad_prev starts at 0 all the same. t_limit: (U,)
    effective lengths; unit u stops at t_limit[u] (its state freezes and
    adds 0 to logZ; its smoothing buffer is flushed at t_limit[u] - 1), so
    with the same draws its first t_limit[u] rows are a run of that length.

    Per site, as the reference's OnlineCombinedInference::run: SMC step,
    backward kernels, smoothing update, parameter-estimation update.
    """
    eng = _Engine(model, theta_init, emissions, config, n_units, weight_dtype, adam_init, t_limit)
    u_sys, u_mult = _check_uniforms(eng.T, eng.U, eng.M, u_sys, u_mult, generator, eng.device)
    for t in range(1, eng.T):
        eng.step(t, *_site_uniforms(t, eng.U, eng.M, u_sys, u_mult, generator, eng.device,
                                    shared_draws))
    return eng.result()


def run_online_combined_inference_chunked(
    model: SingleGroupModel,
    theta_init,
    emissions,
    config: EngineConfig,
    *,
    chunk_size,
    checkpoint_path=None,
    resume=True,
    n_units=1,
    generator=None,
    u_sys=None,
    u_mult=None,
    weight_dtype=torch.float32,
) -> EngineResult:
    """The same run with a checkpoint every ``chunk_size`` sites.

    After each chunk but the last, the whole state (particles, weights, psi
    and phi, theta and the ADAM moments, the output so far, the generator's
    state) goes to ``checkpoint_path`` (.npz). A run restarted with
    ``resume=True`` continues from the last checkpoint of a run of the same
    length; the file is removed when the run completes. Gives the same
    EngineResult as ``run_online_combined_inference``.
    """
    eng = _Engine(model, theta_init, emissions, config, n_units, weight_dtype)
    u_sys, u_mult = _check_uniforms(eng.T, eng.U, eng.M, u_sys, u_mult, generator, eng.device)
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        with np.load(checkpoint_path, allow_pickle=False) as ck:
            if int(ck["version"]) == _CHECKPOINT_VERSION and int(ck["T"]) == eng.T:
                eng.load(ck, generator if u_sys is None else None)
    t = eng.state["next_t"]
    while t < eng.T:
        stop = min(t + chunk_size, eng.T)
        for s in range(t, stop):
            eng.step(s, *_site_uniforms(s, eng.U, eng.M, u_sys, u_mult, generator, eng.device))
        t = stop
        if checkpoint_path and t < eng.T:
            eng.save(checkpoint_path, generator if u_sys is None else None)
    if checkpoint_path and os.path.exists(checkpoint_path):
        os.remove(checkpoint_path)
    return eng.result()
