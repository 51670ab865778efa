"""Within-chromosome blocked single-group inference: the theta stage's
sequential chain spread over halo-buffered blocks of one chromosome.

Counterpart of hygeia_tpu/single_group/blocked.py, the same scheme:

1. WARMUP: a parameters-only chain (the regime pass off) over the first
   ``warmup_sites`` sites moves theta most of the way to convergence.
   Under ``_multi`` the chains of several chromosomes run as the units of
   one engine call, each over the shared prefix min(T_c, warmup_sites).
   Skipped when parameters are fixed.
2. BLOCKS: every chromosome is split into ``block_size``-site blocks, each
   run over a window extended left by ``halo`` sites (block 0 starts at
   site 0 like the sequential chain; the last window is anchored at the
   chromosome's end, overlapping its predecessor, so every window holds
   ``block_size + halo`` real sites). All (chromosome, block) windows run
   as the U units of ONE engine call, one resampler launch per site for
   all of them, each with its chromosome's warm theta and ADAM state.

Host assembly: each block's rows with the halo dropped; each trace
expanded from its update rows (theta changes only at update steps); the
warmup chain's trace as the prefix; the final theta, the mean of the
blocks' final thetas, as the last trace row. logZ is the sum of the
windows' logZ (the windows overlap, so it is not the chromosome's logZ;
no stage reads it), spills their sum.

A chromosome shorter than two blocks (or than one window) takes the
sequential engine. Randomness, as the JAX package's keys: the warmup and
every sequential chromosome take the draws of the caller's generator from
its state at the call (JAX: ``key``), the blocks fresh draws after the
warmup's (JAX: block b draws from ``fold_in(key, 1_000_003 + b)``). A test
injects the JAX draws instead through ``uniforms``.
The JAX module's ahead-of-time compile thread has no counterpart.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hygeia_tpu_torch.single_group.engine import (
    EngineConfig,
    EngineResult,
    run_online_combined_inference,
)
from hygeia_tpu_torch.single_group.model import SingleGroupModel
from hygeia_tpu_torch.single_group.theta_config import (
    THETA_BLOCK_SIZE,
    THETA_HALO,
    THETA_WARMUP_SITES,
)

def _expand_trace(upd, j_lo, j_hi, base, su):
    """Rows j_lo..j_hi-1 of a chain's theta trace from its update rows:
    ``base`` before the first update, then update row j // su - 1."""
    j = np.arange(j_lo, j_hi)
    rows = np.concatenate([np.asarray(base)[None], upd], axis=0)
    return rows[np.minimum(j // su, len(upd))]


def _update_rows(trace, su):
    """(U, n_upd, D) host copy of the trace rows at update steps su, 2su, ..."""
    T = trace.shape[1]
    n_upd = max(0, (T - 1) // su)
    return trace[:, su : n_upd * su + 1 : su].cpu().numpy()


def _chain_draws(uniforms, chains, T):
    """Injected (u_sys (T-1, U), u_mult (T-1, U, M)) for the engine from one
    chain's draws per unit: ``uniforms(T, block)`` with block None for the
    caller's own chain."""
    draws = [uniforms(T, b) for b in chains]
    us = np.stack([np.asarray(d[0]).reshape(T - 1) for d in draws], axis=1)
    um = np.stack([np.asarray(d[1]).reshape(T - 1, -1) for d in draws], axis=1)
    return us, um


def _host_result(res):
    """One unit's EngineResult as host numpy arrays without the unit axis."""
    return EngineResult(
        regime_probs=res.regime_probs[0].cpu().numpy(),
        regime_valid=res.regime_valid[0].cpu().numpy(),
        theta_trace=res.theta_trace[0].cpu().numpy(),
        log_normalizing_constant=float(res.log_normalizing_constant[0]),
        spill_count=int(res.spill_count[0]),
        final_theta=res.final_theta[0].cpu().numpy(),
        final_score=res.final_score[0].cpu().numpy(),
        final_opt_state=None,
    )


def run_online_combined_inference_blocked(
    model: SingleGroupModel,
    theta_init,
    emissions,
    config: EngineConfig,
    *,
    block_size: int = THETA_BLOCK_SIZE,
    halo: int = THETA_HALO,
    warmup_sites: int = THETA_WARMUP_SITES,
    generator=None,
    uniforms=None,
    weight_dtype=torch.float32,
    timings=None,
) -> EngineResult:
    """Blocked drop-in for ``run_online_combined_inference`` on one
    chromosome's (T, R) table: an EngineResult of host numpy arrays without
    the unit axis (see the module docstring for each field)."""
    return run_online_combined_inference_blocked_multi(
        model, [theta_init], [emissions], config, block_size=block_size, halo=halo,
        warmup_sites=warmup_sites, generator=generator, uniforms=uniforms,
        weight_dtype=weight_dtype, timings=timings,
    )[0]


def run_online_combined_inference_blocked_multi(
    model: SingleGroupModel,
    theta_inits,
    emissions_list,
    config: EngineConfig,
    *,
    block_size: int = THETA_BLOCK_SIZE,
    halo: int = THETA_HALO,
    warmup_sites: int = THETA_WARMUP_SITES,
    generator=None,
    uniforms=None,
    weight_dtype=torch.float32,
    timings=None,
):
    """The blocked theta stage over several chromosomes: their warmup chains
    as the units of one engine call, then all their (chromosome, block)
    windows as the units of one more. ``emissions_list``: [C] (T_c, R)
    tables on the engine's device. Returns [C] EngineResults of host numpy
    arrays (no unit axis).

    Randomness: ``generator`` (its state at the call is the JAX package's
    ``key``), or ``uniforms(T, block)`` -> (u_sys (T-1,), u_mult (T-1, M))
    for the chain of ``block`` (None: the caller's own chain, which the
    warmup and the sequential chromosomes take). ``timings``, a dict, gets
    the wall seconds of the two engine calls ("warmup_s", "blocks_s"; the
    device synchronised after each)."""
    if (generator is None) == (uniforms is None):
        raise ValueError("pass a torch.Generator or uniforms, not both or neither")
    Es = [torch.as_tensor(E).to(weight_dtype) for E in emissions_list]
    device = Es[0].device
    R, D = model.n_regimes, model.dim_theta
    win = block_size + halo
    su = config.steps_per_update
    key_state = generator.get_state() if generator is not None else None

    def chain(T, chains, shared):
        """Engine randomness for a call of chains of length T."""
        if uniforms is not None:
            us, um = _chain_draws(uniforms, chains, T)
            return dict(u_sys=us, u_mult=um)
        if shared:
            generator.set_state(key_state)
        return dict(generator=generator, shared_draws=shared)

    def theta_of(c):
        return torch.as_tensor(theta_inits[c], dtype=weight_dtype, device=device)

    results: list = [None] * len(Es)
    blocked = []
    for c, E in enumerate(Es):
        T = E.shape[0]
        if -(-T // block_size) <= 1 or T < win:
            res = run_online_combined_inference(model, theta_of(c), E, config, n_units=1,
                                                weight_dtype=weight_dtype, **chain(T, [None], True))
            results[c] = _host_result(res)
        else:
            blocked.append(c)
    if not blocked:
        return results

    def _timed(name, t0):
        if timings is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            timings[name] = time.perf_counter() - t0

    # ---- 1. warmup chains, one unit per chromosome -------------------------
    Cb = len(blocked)
    theta0 = torch.stack([theta_of(c) for c in blocked])  # (Cb, D)
    warm_traces = {}
    if config.estimate_parameters:
        Tw = int(min(warmup_sites, min(Es[c].shape[0] for c in blocked)))
        Ew = torch.stack([Es[c][:Tw] for c in blocked])
        t0 = time.perf_counter()
        res = run_online_combined_inference(
            model, theta0, Ew, config._replace(estimate_regimes=False), n_units=Cb,
            weight_dtype=weight_dtype, **chain(Tw, [None] * Cb, True))
        _timed("warmup_s", t0)
        upd_w = _update_rows(res.theta_trace, su)
        base = theta0.cpu().numpy()
        for i, c in enumerate(blocked):
            warm_traces[c] = _expand_trace(upd_w[i], 0, Tw, base[i], su)
        theta0 = res.final_theta
        adam0 = res.final_opt_state
    else:
        zeros = torch.zeros((Cb, D), dtype=weight_dtype, device=device)
        adam0 = (zeros, zeros, torch.zeros((Cb,), dtype=torch.int64, device=device))

    # ---- 2. every (chromosome, block) window as one unit ------------------
    windows, meta = [], []  # meta: (chromosome slot, halo rows, global start, global end)
    for ci, c in enumerate(blocked):
        T = Es[c].shape[0]
        n_blocks = -(-T // block_size)
        for b in range(n_blocks):
            g_start = b * block_size
            g_end = min(T, g_start + block_size)
            s = T - win if b == n_blocks - 1 else max(0, g_start - halo)
            windows.append(Es[c][s : s + win])
            meta.append((ci, g_start - s, g_start, g_end))
    slot = torch.as_tensor([m[0] for m in meta], device=device)
    block_ids = [m[2] // block_size for m in meta]
    t0 = time.perf_counter()
    res = run_online_combined_inference(
        model, theta0[slot], torch.stack(windows), config, n_units=len(meta),
        weight_dtype=weight_dtype, adam_init=tuple(a[slot] for a in adam0),
        **chain(win, block_ids, False))
    _timed("blocks_s", t0)

    # ---- 3. host assembly ---------------------------------------------------
    probs_b = res.regime_probs.cpu().numpy()
    valid_b = res.regime_valid.cpu().numpy()
    upd_b = _update_rows(res.theta_trace, su)
    log_z_b = res.log_normalizing_constant.cpu().numpy()
    spill_b = res.spill_count.cpu().numpy()
    final_b = res.final_theta.cpu().numpy()
    score_b = res.final_score.cpu().numpy()
    theta0_np = theta0.cpu().numpy()
    for ci, c in enumerate(blocked):
        T = Es[c].shape[0]
        probs = np.zeros((T, R), np.float32)
        valid = np.zeros((T,), bool)
        trace = np.zeros((T, D), final_b.dtype)
        rows = [u for u, m in enumerate(meta) if m[0] == ci]
        for u in rows:
            _, lo, g_start, g_end = meta[u]
            n = g_end - g_start
            probs[g_start:g_end] = probs_b[u, lo : lo + n]
            valid[g_start:g_end] = valid_b[u, lo : lo + n]
            trace[g_start:g_end] = _expand_trace(upd_b[u], lo, lo + n, theta0_np[ci], su)
        if c in warm_traces:
            n = min(len(warm_traces[c]), T)
            trace[:n] = warm_traces[c][:n]
        if config.estimate_parameters:
            final_theta = np.mean(final_b[rows], axis=0)
        else:
            final_theta = theta0_np[ci]
        trace[-1] = final_theta
        results[c] = EngineResult(
            regime_probs=probs,
            regime_valid=valid,
            theta_trace=trace,
            log_normalizing_constant=float(np.sum(log_z_b[rows])),
            spill_count=int(np.sum(spill_b[rows])),
            final_theta=final_theta,
            final_score=np.mean(score_b[rows], axis=0),
            final_opt_state=None,
        )
    return results
