"""Plain reference of hygeia's single-group online engine, the θ stage.

Written from the published algorithm in plain PyTorch, float64 by
default, one chain: the discrete change-point particle filter of
Fearnhead and Liu (2007) over states (d, r), d the sojourn and r the
methylation regime, with Fearnhead's optimal finite-state resampling (N
particles; M = N - R continuations kept by resampling, and R fresh
change-point particles a site, one a regime, each weighted by the whole
filter at t - 1); adaptive-lag marginal smoothing (each site's regime
marginal is carried forward under the backward kernel until its R
variances fall below ε, for at most ``smoothing_window`` entries or
sites); the online score recursion φ of Poyiadjis, Doucet and Singh
(2011), as upstream hygeia's ``OnlineParameterEstimation.h`` runs it; an
ADAM step (Kingma and Ba) every ``steps_per_update`` sites, learning rate
factor / (i + 1)^exponent at the i-th step; the hazard and transition
tables rebuilt from θ after each step. It imports nothing of the program.

θ packs the R(R - 1) off-diagonal entries of P row-major (each row a
softmax over its off-diagonal entries), then logit ω (R); κ is fixed.
The sojourn past the minimum duration u is negative binomial,
h(x) = C(x + κ - 1, x) ω^x (1 - ω)^κ, x = d - u, and the hazard at sojourn
d is ρ(d) = h(x) / S(x), S(x) = P(K >= x), summed here from the far tail
in log space; ρ = 0 below u. Tables stop at d_max: a longer sojourn reads
the last column.

Departures from upstream, each the program's convention:
- the resampler runs in float32, as the program's kernel K1 does, and
  hands back float32 weights (its kept weights and -log c); where fewer
  than M + 1 weights are finite, or no c is consistent in float32, the M
  heaviest particles are kept with their weights (upstream's top-M rule).
  float32 finds no c where most weights lie below its smallest exp
  (log weights under ~-103), which float64 would still resample;
- the ω entry of a fresh particle's score term keeps the log ρ gradient
  on the exit latch, where the density drops its ρ factor (upstream's);
- the exit latch. The exact model has none (S > 0 everywhere), but a
  table in the stated precision sums h from the head, and where S falls
  below that sum's rounding the running sum reaches 1 and the model
  forces a change point (ρ = 1, continuation impossible; the change
  point's density drops ρ). Where float32 cannot hold S, the program's
  ρ is no longer ρ either: its float32 lgamma and the rounding of the
  running sum decide it, and a table that is the JAX package's bit for
  bit must not read as a fault. So where S < ``SOUND_SURVIVAL`` of the
  stated precision (float32: 2^-10, where the running sum's rounding
  over 4,096 columns reaches a quarter of S), the per-site checks take
  the program's own table (``Tables.latched``); the reference's own runs
  have no latch (ρ comes from log h - log S, which does not underflow);
- κ is fixed (the θ stage's setting); the κ-free model is not covered.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from perfbench.reference import two_group as tg

F64 = torch.float64
NEG = float("-inf")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
SOUND_SURVIVAL = {torch.float32: 2.0 ** -10, torch.float64: 2.0 ** -40}
LOG_FLT_MIN = -126 * math.log(2.0)  # log of float32's smallest normal number

alpha_beta = tg.alpha_beta
emission_table = tg.emission_table


class Settings(NamedTuple):
    """The engine's settings, as the configuration states them; both
    estimates (regimes and θ) are on, as the θ stage runs them."""

    n_regimes: int
    u: int
    kappa: float
    d_max: int
    n_particles: int
    epsilon: float = 0.01
    smoothing_window: int = 128
    steps_per_update: int = 200
    learning_rate_factor: float = 0.01
    learning_rate_exponent: float = 0.1

    @property
    def dim_theta(self):
        return self.n_regimes ** 2


# ---- θ and the tables ----------------------------------------------------------

def p_column(R, r, j):
    """θ's column of P[r, j], j != r."""
    return r * (R - 1) + (j if j < r else j - 1)


def transition_matrix(theta, R, dtype=F64):
    """P (R, R) with a zero diagonal: each row the softmax of its
    off-diagonal θ entries."""
    theta = torch.as_tensor(theta).to(dtype)
    P = torch.zeros((R, R), dtype=dtype)
    for r in range(R):
        row = theta[r * (R - 1):(r + 1) * (R - 1)]
        p = torch.softmax(row, 0)
        P[r, [j for j in range(R) if j != r]] = p
    return P


def omega_of(theta, R, dtype=F64):
    return torch.sigmoid(torch.as_tensor(theta).to(dtype)[R * (R - 1):R * R])


def hazard(kappa, omega, u, d_max, dtype=F64):
    """(ρ, S, ∂ log ρ / ∂ logit ω), each (R, d_max) in float64, column d - 1
    for sojourn d: ρ = h(x) / S(x) with x = d - u, S(x) = P(K >= x) (1 below
    u, where ρ and its gradient are 0), the tail summed until its terms fall
    below 1e-30 (or 2 million terms, for ω within ~3e-5 of 1). With
    g(x) = ∂ log h / ∂ logit ω = x (1 - ω) - κ ω, ∂ log S(x) =
    E[g(K) | K >= x], so the gradient is
    (1 - ω) (x - E[K | K >= x]). ``dtype``: the precision it is computed
    in (the control's), returned as float64."""
    omega = torch.as_tensor(omega, dtype=F64)[:, None]
    k_top = min(d_max + int(math.ceil(math.log(1e-30) / math.log(float(omega.max())))) + 64, 2_000_000)
    omega = omega.to(dtype)
    kappa = torch.as_tensor(kappa, dtype=F64).to(dtype) * torch.ones_like(omega)
    k = torch.arange(k_top, dtype=F64).to(dtype)[None, :]
    log_h = (torch.lgamma(k + kappa) - torch.lgamma(kappa) - torch.lgamma(k + 1)
             + kappa * torch.log1p(-omega) + k * torch.log(omega))
    rev = lambda x: torch.flip(torch.logcumsumexp(torch.flip(x, [1]), 1), [1])
    log_s = rev(log_h)
    log_ks = rev(log_h + torch.log(k.clamp(min=1.0)) + torch.where(k > 0, 0.0, NEG))  # log sum_{j>=x} j h(j)
    d = torch.arange(1, d_max + 1)
    x = (d - u).clamp(min=0)
    live = d >= u
    rho = torch.where(live, torch.exp(log_h[:, x] - log_s[:, x]), 0.0)
    surv = torch.where(live, torch.exp(log_s[:, x]), 1.0)
    mean_k = torch.exp(log_ks[:, x] - log_s[:, x])
    grad = torch.where(live, (1.0 - omega) * (x.to(dtype) - mean_k), 0.0)
    return rho.to(F64), surv.to(F64), grad.to(F64)


class Tables(NamedTuple):
    """What θ determines: P and log P (R, R), and the (R, d_max) hazard
    ρ, the exit latch, ∂ log ρ / ∂ logit ω and the survival S."""

    P: torch.Tensor
    log_P: torch.Tensor
    rho: torch.Tensor
    exit: torch.Tensor
    grad: torch.Tensor
    surv: torch.Tensor

    @classmethod
    def of(cls, theta, s: Settings):
        R = s.n_regimes
        P = transition_matrix(theta, R)
        rho, surv, grad = hazard(s.kappa, omega_of(theta, R), s.u, s.d_max)
        log_P = torch.where(P > 0, torch.log(P), NEG)
        return cls(P, log_P, rho, torch.zeros_like(rho, dtype=torch.bool), grad, surv)

    def unsound(self, dtype):
        """The columns where the stated precision cannot hold S."""
        return self.surv < SOUND_SURVIVAL[dtype]

    def latched(self, rho, exit_, grad, dtype=torch.float32):
        """These tables with the program's ρ, latch and gradient where the
        stated precision ``dtype`` cannot hold S (the latch rule)."""
        bad = self.unsound(dtype)
        pick = lambda mine, prog: torch.where(bad, torch.as_tensor(prog).to(mine.dtype), mine)
        return self._replace(rho=pick(self.rho, rho), exit=pick(self.exit, exit_), grad=pick(self.grad, grad))

    def lookup(self, d, r):
        """(ρ, exit, gradient) at sojourns d (clamped to [1, d_max]) and
        regimes r."""
        R, W = self.rho.shape
        i = r.clamp(0, R - 1), (d - 1).clamp(0, W - 1)
        return self.rho[i], self.exit[i], self.grad[i]


def hazard_gap(tabs: Tables, rho, exit_, dtype=torch.float32):
    """The largest relative gap of the program's ρ (R, d_max) to the
    reference's, where the stated precision holds S; 1 where the program
    latches there."""
    sound = ~tabs.unsound(dtype) & (tabs.rho > 0)
    rho = torch.as_tensor(rho).to(F64)
    rel = ((rho - tabs.rho).abs() / tabs.rho.clamp(min=1e-300))[sound]
    gap = float(rel.max()) if rel.numel() else 0.0
    return max(gap, 1.0 if bool((torch.as_tensor(exit_).bool() & sound).any()) else 0.0)


# ---- the filter's site ------------------------------------------------------------

def initial_state(E0, theta, s: Settings):
    """The state at site 0: R particles (1, r) weighted 1/R times the
    emission, the smoothing entry of time 0, θ and a fresh ADAM state."""
    R, N, D, S = s.n_regimes, s.n_particles, s.dim_theta, s.smoothing_window
    first = torch.arange(N) < R
    r = torch.where(first, torch.arange(N), 0)
    raw = torch.where(first, -math.log(R) + E0.to(F64)[r], NEG)
    shift = torch.logsumexp(raw, 0)
    psi = torch.zeros((S, R, N), dtype=F64)
    psi[0] = ((r[None, :] == torch.arange(R)[:, None]) & first).to(F64)
    zeros = torch.zeros(D, dtype=F64)
    return dict(d=first.long(), r=r, w=raw - shift, shift=float(shift), psi=psi,
                psi_time=torch.zeros(S, dtype=torch.int64), psi_valid=torch.arange(S) == 0,
                phi=torch.zeros((N, D), dtype=F64), score=zeros, grad_prev=zeros.clone(),
                adam_m=zeros.clone(), adam_v=zeros.clone(), adam_iter=0,
                theta=torch.as_tensor(theta).to(F64).clone(), spill=0)


def _f32_threshold(w, M):
    """Fearnhead's threshold in float32 for normalised log weights w (N,):
    (K, log c, the particles by descending weight, exp w) with K the
    particles kept, c W_i >= 1; None where no c is consistent."""
    w = torch.as_tensor(w, dtype=torch.float32)
    N = w.numel()
    kk = min(M + 1, N)
    vals, idx = torch.sort(w, descending=True, stable=True)
    top = vals[:kk]
    ew = torch.exp(w)
    in_top = torch.zeros(N, dtype=torch.bool)
    in_top[idx[:kk]] = True
    suffix = torch.flip(torch.cumsum(torch.flip(torch.exp(top), [0]), 0), [0]) + torch.where(in_top, 0.0, ew).sum()
    k = torch.arange(kk, dtype=torch.float32)
    log_c_k = torch.log((M - k).clamp(min=0.0)) - torch.log(suffix)
    prev = torch.cat([torch.full((1,), math.inf), top[:-1]])
    ok = (log_c_k + top <= 0.0) & (log_c_k + prev >= 0.0) & (k <= M)
    if not bool(ok.any()):
        return None
    ks = int(torch.nonzero(ok)[0, 0])
    return ks, log_c_k[ks], idx, ew


def resample(w, M, u_sys):
    """Fearnhead's optimal resampling of normalised log weights w (N,) in
    float32: the c with sum_i min(1, c W_i) = M, the K particles with
    c W_i >= 1 kept (heaviest first), the other M - K drawn systematically
    in slot order from the rest, on the grid (j + u) / (M - K) of their
    total. (parents (M,), their float32 log weights: the kept their own,
    the drawn -log c), or None where no c is consistent. Where the rest's
    mass underflows float32 the grid is all 0 and every draw is slot 0."""
    w = torch.as_tensor(w, dtype=torch.float32)
    got = _f32_threshold(w, M)
    if got is None:
        return None
    ks, log_c, idx, ew = got
    kept = idx[:ks]
    resid = ew.clone()
    resid[kept] = 0.0
    q = torch.cumsum(resid, 0)
    L = M - ks
    t = (torch.arange(L, dtype=torch.float32) + torch.as_tensor(u_sys, dtype=torch.float32)) / float(max(L, 1)) * q[-1]
    drawn = torch.searchsorted(q, t).clamp(max=w.numel() - 1)
    return torch.cat([kept, drawn]), torch.cat([w[kept], (-log_c).expand(L)])


def residual_underflows(w, M):
    """Whether float32's optimal resampling of w finds a c but the mass of
    the particles it does not keep rounds to 0 (every draw is then slot
    0, one of the kept: copies of it, weighted -log c)."""
    got = _f32_threshold(w, M)
    if got is None:
        return False
    ks, _, idx, ew = got
    return float(ew[idx[ks:]].sum()) == 0.0


def choose_ancestors(w, M, u_sys):
    """(ancestors (M,), their log weights in float64) of a site at
    capacity: optimal resampling, or the M heaviest with their weights."""
    w = torch.as_tensor(w).to(F64)
    got = resample(w.to(torch.float32), M, u_sys) if int(torch.isfinite(w).sum()) > M else None
    if got is None:
        top = torch.sort(w.to(torch.float32), descending=True, stable=True).indices[:M]
        return top, w[top]
    parents, new_w = got
    return parents, new_w.to(F64)


def keeps_the_heaviest(w, M):
    """Whether the stated precision's resampler keeps the M heaviest
    particles of normalised log weights w (N,): M or fewer are finite, or
    no c is consistent in float32 (where most weights lie below float32's
    smallest exp, their mass rounds to 0)."""
    w = torch.as_tensor(w)
    return int(torch.isfinite(w).sum()) <= M or resample(w.to(torch.float32), M, 0.5) is None


def reference_ancestor_weights(w_prev, anc, M, implied=None):
    """The weights optimal resampling gives the ancestors ``anc`` of
    normalised log weights ``w_prev``, in float64: max(w, -log c), or w
    where the M heaviest are kept (``keeps_the_heaviest``). Given the
    weights the program's continuations imply (``implied``), an ancestor
    that appears more than once may weigh -log c in its copies (a kept
    particle drawn again: ``residual_underflows``), where that fits."""
    w_prev = torch.as_tensor(w_prev).to(F64)
    wa = w_prev[anc.clamp(min=0)]
    if keeps_the_heaviest(w_prev, M):
        return wa
    log_c = tg.optimal_log_c(w_prev, M)
    if log_c is None:
        return wa
    factor = torch.maximum(wa, torch.full_like(wa, -log_c))
    if implied is None:
        return factor
    copies = torch.bincount(anc.clamp(min=0), minlength=w_prev.numel())[anc.clamp(min=0)] > 1
    implied = torch.as_tensor(implied).to(F64)
    closer = (implied + log_c).abs() < (implied - factor).abs()
    return torch.where(copies & closer, torch.full_like(wa, -log_c), factor)


def propagate(tabs: Tables, E_t, d, r, w, anc, anc_w, s: Settings):
    """Site t from the particles (d, r, w) at t - 1 and the ancestors kept:
    (raw log weights (N,), d, r at t, B (R, N) the backward kernel of each
    fresh particle, the lookups at the ancestors and at t - 1)."""
    R, N = s.n_regimes, s.n_particles
    E_t = torch.as_tensor(E_t).to(F64)
    m = anc.numel()
    n_dead = N - m - R
    rho_a, exit_a, grad_a = tabs.lookup(d[anc], r[anc])
    cont = torch.where(exit_a | (rho_a > 1.0), NEG, torch.log1p(-rho_a))
    w_cont = anc_w + cont + E_t[r[anc].clamp(0, R - 1)]
    rho_n, exit_n, grad_n = tabs.lookup(d, r)
    q = torch.arange(R)[:, None]
    valid = (q != r[None, :]) & (d >= s.u)[None, :]
    log_rho = torch.where(exit_n, 0.0, torch.log(rho_n))
    cp = torch.where(valid, log_rho[None, :] + tabs.log_P[r.clamp(0, R - 1)[None, :], q], NEG)
    log_b = cp + torch.where(torch.isfinite(w), w, NEG)[None, :]
    log_bz = torch.logsumexp(log_b, 1, keepdim=True)
    B = torch.where(torch.isfinite(log_bz), torch.exp(log_b - log_bz), 0.0)
    raw = torch.cat([w_cont, log_bz[:, 0] + E_t, torch.full((n_dead,), NEG, dtype=F64)])
    zeros = torch.zeros(n_dead, dtype=d.dtype)
    d_new = torch.cat([d[anc] + 1, torch.ones(R, dtype=d.dtype), zeros])
    r_new = torch.cat([r[anc], torch.arange(R, dtype=r.dtype), zeros])
    return raw, d_new, r_new, B, (rho_a, exit_a, grad_a), (grad_n, valid)


def mix(stat, anc, B, n_dead, axis):
    """A statistic of the particles at t - 1 carried to the slots at t:
    at the ancestor for a continuation, under B for a fresh particle, 0
    for a dead slot. ``axis`` is the particle axis: -1 for the smoothing
    entries (S, R, N), 0 for φ (N, D)."""
    if axis == -1:
        parts = stat[..., anc], stat @ B.T, stat.new_zeros((*stat.shape[:-1], n_dead))
    else:
        parts = stat[anc], B @ stat, stat.new_zeros((n_dead, *stat.shape[1:]))
    return torch.cat(parts, axis)


def score_terms(tabs: Tables, r, anc, at_anc, at_prev, s: Settings):
    """The score recursion's new terms: the continuations' (m, D), each
    ∂ log(1 - ρ) at its ancestor, and the fresh particles' (R, N, D), each
    ∂ log f((1, q) | particle n), 0 where the change point is impossible."""
    R, D = s.n_regimes, s.dim_theta
    rho_a, exit_a, grad_a = at_anc
    grad_n, valid = at_prev
    om = R * (R - 1)
    coef = torch.where(exit_a | (rho_a >= 1.0), 0.0, -rho_a / (1.0 - rho_a))
    g_cont = torch.zeros((anc.numel(), D), dtype=F64)
    g_cont[torch.arange(anc.numel()), om + r[anc].clamp(0, R - 1)] = coef * grad_a
    # ∂ log P[r, q] / ∂ θ[p_column(r, j)] = 1[j == q] - P[r, j]
    dP = torch.zeros((R, R, D), dtype=F64)
    for rr in range(R):
        for j in range(R):
            if j != rr:
                dP[rr, :, p_column(R, rr, j)] = (torch.arange(R) == j).to(F64) - tabs.P[rr, j]
    rn = r.clamp(0, R - 1)
    g = dP[rn].transpose(0, 1).clone()  # (R, N, D)
    g[:, torch.arange(r.numel()), om + rn] += grad_n[None, :]
    return g_cont, torch.where(valid[..., None], g, 0.0)


def phi_step(tabs: Tables, r, phi, anc, B, at_anc, at_prev, s: Settings):
    """φ at t (N, D) from φ at t - 1: carried as ``mix`` carries it, plus
    each slot's new term (``score_terms``), a fresh particle's averaged
    under B."""
    m, R = anc.numel(), s.n_regimes
    g_cont, g_cp = score_terms(tabs, r, anc, at_anc, at_prev, s)
    out = mix(torch.as_tensor(phi).to(F64), anc, B, s.n_particles - m - R, 0)
    out[:m] += g_cont
    out[m:m + R] += torch.einsum("qn,qnd->qd", B, g_cp)
    return out


def adam(theta, m, v, it, gradient, s: Settings, dtype=F64):
    """One ADAM step of θ up the gradient (the i-th, i = it + 1):
    (θ, m, v)."""
    c = lambda x: torch.as_tensor(x).to(dtype)
    theta, m, v, gradient = c(theta), c(m), c(v), c(gradient)
    i = float(it) + 1.0
    lr = s.learning_rate_factor / i ** s.learning_rate_exponent
    m = ADAM_B1 * m + (1 - ADAM_B1) * gradient
    v = ADAM_B2 * v + (1 - ADAM_B2) * gradient * gradient
    delta = lr * m / (torch.sqrt(v / (1.0 - ADAM_B2 ** i)) + ADAM_EPS) / (1.0 - ADAM_B1 ** i)
    return theta + delta, m, v


def smooth(st, psi_new, r_new, W, t, n_live, s: Settings, final, out, out_valid):
    """The smoothing entries at t: insert time t (forcing out the oldest
    pending entry where none is free: a spill), then finalise the entries
    whose R variances under W all fall below ε, those S sites old (spills)
    and, at the last site, all. Writes the finalised means into ``out``."""
    R, S = s.n_regimes, s.smoothing_window
    valid, times = st["psi_valid"].clone(), st["psi_time"].clone()
    spill = st["spill"]
    if bool(valid.all()):
        ins = int(torch.where(valid, times, 2**62).argmin())
        spill += 1
        out[int(times[ins])] = psi_new[ins] @ W
        out_valid[int(times[ins])] = True
    else:
        ins = int((~valid).to(torch.uint8).argmax())
    alive = torch.arange(W.numel()) < n_live
    psi_new[ins] = ((r_new[None, :] == torch.arange(R)[:, None]) & alive).to(F64)
    times[ins], valid[ins] = t, True
    means = psi_new @ W
    second = ((psi_new - means[..., None]) ** 2) @ W
    below = (second < s.epsilon).all(-1)
    if final:
        fin = valid
    else:
        aged = times <= t - S
        spill += int((valid & aged & ~below).sum())
        fin = valid & (below | aged)
    for e in torch.nonzero(fin)[:, 0].tolist():
        out[int(times[e])] = means[e]
        out_valid[int(times[e])] = True
    return dict(psi=psi_new, psi_time=times, psi_valid=valid & ~fin, spill=spill)


def advance(tabs: Tables, E_t, st, t, anc, anc_w, s: Settings, final, out, out_valid):
    """The state at site t from the state ``st`` at t - 1 and the ancestors
    kept: (state, whether θ was updated)."""
    R, N = s.n_regimes, s.n_particles
    raw, d_new, r_new, B, at_anc, at_prev = propagate(tabs, E_t, st["d"], st["r"], st["w"], anc, anc_w, s)
    shift = torch.logsumexp(raw, 0)
    w = raw - shift
    W = torch.where(torch.isfinite(w), torch.exp(w), 0.0)
    n_dead = N - anc.numel() - R
    new = dict(st, d=d_new, r=r_new, w=w, shift=float(shift))
    psi = torch.where(st["psi_valid"][:, None, None], mix(st["psi"], anc, B, n_dead, -1), 0.0)
    new.update(smooth(st, psi, r_new, W, t, anc.numel() + R, s, final, out, out_valid))
    phi = phi_step(tabs, st["r"], st["phi"], anc, B, at_anc, at_prev, s)
    score = W @ phi
    new.update(phi=phi, score=score)
    updated = t % s.steps_per_update == 0
    if updated:
        theta, m, v = adam(st["theta"], st["adam_m"], st["adam_v"], st["adam_iter"], score - st["grad_prev"], s)
        new.update(theta=theta, adam_m=m, adam_v=v, adam_iter=st["adam_iter"] + 1, grad_prev=score)
    return new, updated


def run(E, theta0, s: Settings, u_sys):
    """The engine over the T sites of emission table E (T, R), from θ0,
    with the systematic uniforms ``u_sys`` (T - 1,) of sites 1..T-1:
    {regime_probs (T, R), regime_valid (T,), theta_trace (T, D), log_z,
    spill, final_score (D,)}."""
    E = torch.as_tensor(E).to(F64)
    T, R, N = E.shape[0], s.n_regimes, s.n_particles
    M = N - R
    st = initial_state(E[0], theta0, s)
    tabs = Tables.of(st["theta"], s)
    out = torch.zeros((T + 1, R), dtype=F64)
    out_valid = torch.zeros(T + 1, dtype=torch.bool)
    if T > 1:
        W0 = torch.where(torch.isfinite(st["w"]), torch.exp(st["w"]), 0.0)
        means = st["psi"][0] @ W0
        if bool((((st["psi"][0] - means[:, None]) ** 2) @ W0 < s.epsilon).all()):
            out[0], out_valid[0] = means, True
            st["psi_valid"] = torch.zeros_like(st["psi_valid"])
    trace = [st["theta"]]
    log_z = st["shift"]
    for t in range(1, T):
        n_prev, m_t = min(R * t, N), min(R * (t + 1), N) - R
        if n_prev + R > N:
            anc, anc_w = choose_ancestors(st["w"], M, u_sys[t - 1])
        else:
            anc, anc_w = torch.arange(m_t), st["w"][:m_t]
        st, updated = advance(tabs, E[t], st, t, anc, anc_w, s, t == T - 1, out, out_valid)
        if updated:
            tabs = Tables.of(st["theta"], s)
        trace.append(st["theta"])
        log_z += st["shift"]
    return dict(regime_probs=out[:T], regime_valid=out_valid[:T], theta_trace=torch.stack(trace),
                log_z=log_z, spill=st["spill"], final_score=st["score"])


# ---- reading the program's state -----------------------------------------------

def state_keys(d, r):
    """One int64 a particle, equal where (d, r) are."""
    return d.to(torch.int64) * 64 + r.to(torch.int64)


def read_ancestors(prev, cur, M, R, factor, implied):
    """The slots at t - 1 of the ancestors of the M continuations at t,
    read off their states (d - 1, r): (ancestors (M,), -1 where no particle
    at t - 1 has that state; the count of slots at t whose state the layout
    does not allow: a continuation with no such ancestor, a fresh particle
    that is not (1, q) in regime order, a live dead slot). A particle of
    weight 0 may be an ancestor: the top-M rule keeps such particles where
    M or fewer weights are positive. Where states repeat at t - 1 (copies
    of one particle, whose weights part once resampling keeps one and draws
    the other), the candidate whose weight after resampling, ``factor``
    (N,), lies nearest the one the program's weight at t implies,
    ``implied`` (M,), is taken."""
    keys_prev = state_keys(prev["d"], prev["r"])
    want = state_keys(cur["d"][:M] - 1, cur["r"][:M])
    hit = want[:, None] == keys_prev[None, :]
    gap = (torch.as_tensor(factor).to(F64)[None, :] - torch.as_tensor(implied).to(F64)[:, None]).abs()
    pick = torch.where(hit, torch.nan_to_num(gap, nan=1e300, posinf=1e300), math.inf).argmin(1)
    anc = torch.where(hit.any(1), pick, -1)
    fresh_ok = (cur["d"][M:M + R] == 1) & (cur["r"][M:M + R] == torch.arange(R))
    dead_live = torch.isfinite(torch.as_tensor(cur["w"])[M + R:])
    bad = int((anc < 0).sum()) + int((~fresh_ok).sum()) + int(dead_live.sum())
    return anc, bad


def _by_state(prev, want, got, free):
    """(wanted not among ``got``, ``got`` beyond the wanted and not
    ``free``), particle indices compared as multisets of their states."""
    keys = state_keys(prev["d"], prev["r"])
    uniq, inv = torch.unique(torch.cat([keys[want], keys[got]]), return_inverse=True)
    need = torch.bincount(inv[:want.numel()], minlength=uniq.numel())
    have = torch.bincount(inv[want.numel():], minlength=uniq.numel())
    spare = torch.zeros(uniq.numel(), dtype=torch.bool)
    spare[inv[want.numel():][free[got]]] = True
    beyond = (have - need).clamp(min=0)
    return int((need - have).clamp(min=0).sum()), int(torch.where(spare, 0, beyond).sum())


def k1_faults(prev, anc, M, R):
    """(survivor gap, heavy dropped, systematic mismatch) of the resampling
    between t - 1 and t. Where optimal resampling ran, the two-group
    reference's checks, with the state at t - 1 and the ancestors laid out
    as its (particle, 5-field state) tensors, one child an ancestor, live
    where the ancestor lived. Where more than M are finite but the M
    heaviest are kept (``keeps_the_heaviest``), those M. Where float32
    cannot resolve the draw (the threshold 1/c lies below its smallest
    normal number, or the mass not kept underflows: ``residual_underflows``),
    the heavy particles of normal mass, and any particle of subnormal mass
    or copies of slot 0 besides. Both count by state the wanted not kept
    and the ancestors beyond the wanted that the rule does not allow."""
    I = 2 * R + R * R
    w = torch.as_tensor(prev["w"]).to(F64)
    a = anc.clamp(min=0)
    live = (anc >= 0) & torch.isfinite(w[a])
    n_fin = int(torch.isfinite(w).sum())
    if n_fin > M and keeps_the_heaviest(w, M):
        want = torch.sort(w.to(torch.float32), descending=True, stable=True).indices[:M]
        return (abs(int(live.sum()) - M), *_by_state(prev, want, a[anc >= 0], torch.zeros(w.numel(), dtype=torch.bool)))
    log_c = tg.optimal_log_c(w, M) if n_fin > M else None
    if log_c is not None and (log_c > -LOG_FLT_MIN or residual_underflows(w, M)):
        # float32 cannot resolve the masses the draw is made from: the heavy
        # of normal mass must be kept; the rest may be any particle of
        # subnormal mass, or copies of slot 0.
        normal = torch.isfinite(w) & (w >= LOG_FLT_MIN)
        want = torch.nonzero(normal & (w + log_c >= 1e-3))[:, 0]
        free = ~normal
        free[0] = True
        return (abs(int(live.sum()) - M), *_by_state(prev, want, a[anc >= 0], free))
    zero = torch.zeros_like(prev["d"])
    parts_prev = torch.stack([zero, prev["d"], prev["r"], zero, zero], -1)
    child = torch.stack([zero[a], prev["d"][a] + 1, prev["r"][a], zero[a] + 1, zero[a]], -1)
    parts_t = torch.cat([child, torch.zeros(((I - 1) * M, 5), dtype=child.dtype)])
    lw_t = torch.full((I * M,), NEG, dtype=F64)
    lw_t[:M] = torch.where(live, 0.0, NEG)
    gap, dropped = tg.resampling_faults(w, parts_prev, parts_t, lw_t, M, R)
    return gap, dropped, tg.systematic_mismatch(w, parts_prev, parts_t, lw_t, M, R)
