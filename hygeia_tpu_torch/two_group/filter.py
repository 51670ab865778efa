"""Deterministic-proposal particle filter for the two-group model.

Counterpart of hygeia_tpu/two_group/filter.py, batched over U units (seeds)
written out as a leading axis. The genome loop is a Python ``for`` over the
sites that never waits for the device: the resampling decision, the
weight-update branch and the degenerate-step reset are tensors under
``torch.where``, with no ``.item()``, no boolean-mask indexing and no
``nonzero``. Every draw comes from an explicit ``torch.Generator``.

* _first_step: R**2 initial proposals scored against the phantom-state
  initial distribution, padded to N = M*I with -inf weights and -1
  particles.
* _one_step: resample M ancestors (optimal finite-state, in f32, through
  ops/cuda_resampling), expand, weight update with the optimal
  -min(0, log_c + log W_ancestor) correction. The JAX filter's
  unbiased-resampling switch is not ported: its INFER path always takes the
  optimal resampler, whose own fallback is multinomial.
* warm start: site 0 scored by _one_step from the previous genome block's
  final (weights, particles) and renormalised like every later site, so a
  warm block continues the filter exactly (two_group/streaming.py).

The emission tables are (T, R), shared by the units, or (U, T, R), one
segment per unit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from hygeia_tpu_torch.ops.cuda_resampling import optimal_resampling
from hygeia_tpu_torch.two_group.model import (
    State,
    TwoGroupParams,
    expand_score_and_observe_stacked,
    phantom_state,
    transition_log_prob,
)
from hygeia_tpu_torch.two_group.proposal import initial_states, num_children

_NEG_INF = float("-inf")
# History storage: durations int32 (sojourns reach the segment length), the
# merged flag and the regimes int8 (-1 marks a dead slot): 15 bytes per
# particle-site with the f32 weight.
_HISTORY_DTYPES = (torch.int8, torch.int32, torch.int8, torch.int32, torch.int8)
HISTORY_BYTES_PER_PARTICLE_SITE = 15


class FilterResult(NamedTuple):
    log_weights: torch.Tensor  # (U, T, N) per-step-normalised log weights
    particles: State  # five (U, T, N) tensors (int8 m/r_c/r_k, int32 d_c/d_k)
    log_normalizing_constant: torch.Tensor  # (U,) init_shift + shifts.sum(-1)
    degenerate_steps: torch.Tensor  # (U,) steps where every weight died
    init_shift: torch.Tensor  # (U,) site 0's shift (first or warm step)
    shifts: torch.Tensor  # (U, T-1) the shifts of sites 1..T-1


def _first_step(params, emission_control, emission_case, n_max, weight_dtype, phantom_r):
    """R**2 initial proposals scored against the phantom-state prior, for
    phantom regimes phantom_r (U,); padded to n_max slots. Returns
    (log weights (U, n_max), stacked particles (U, 5, n_max) int32). The
    emission tables are (T, R) or (U, T, R)."""
    R = params.n_regimes
    U = phantom_r.shape[0]
    dev = params.device
    proposals = initial_states(R, device=dev)  # (R*R,)
    prev = phantom_state(phantom_r[:, None], (U, R * R))
    nxt = State(*(f[None, :] for f in proposals))
    trans_lp = transition_log_prob(params, prev, nxt, step0=True)  # (U, R*R)
    rc, rk = proposals.r_c.long(), proposals.r_k.long()
    obs_lp = emission_control[..., 0, :][..., rc] + emission_case[..., 0, :][..., rk]
    lw = (trans_lp + obs_lp).to(weight_dtype)

    n0 = R * R
    lw_full = torch.full((U, n_max), _NEG_INF, dtype=weight_dtype, device=dev)
    lw_full[:, :n0] = lw
    parts = torch.full((U, 5, n_max), -1, dtype=torch.int32, device=dev)
    parts[:, :, :n0] = torch.stack(tuple(proposals))
    return lw_full, parts


def _one_step(
    params: TwoGroupParams,
    row_c,
    row_k,
    prev_lw,
    prev_particles,
    M,
    u_sys,
    u_mult,
    return_parents=False,
):
    """One filter step for U units: prev_lw (U, N) renormalised weights,
    prev_particles (U, 5, N) int32 stacked fields (m, d_c, r_c, d_k, r_k),
    the site's emission rows (R,) or (U, R), and the step's uniforms u_sys (U,),
    u_mult (U, M). Returns (new_lw (U, N), new_particles (U, 5, N)), and
    with return_parents=True also the (U, M) int64 ancestor indices (the
    marginal filter keys its backward kernels on them).

    Dead ancestors (weight -inf) may be picked as top-M padding parents;
    their children inherit -inf weights.
    """
    dtype = prev_lw.dtype
    U = prev_lw.shape[0]
    # Normalised-weight contract: the caller renormalises every step, so
    # logsumexp(prev_lw) == 0 and log_z_prev is taken as exactly 0.
    need_resample = torch.isfinite(prev_lw).sum(dim=-1) > M  # (U,)
    res = optimal_resampling(prev_lw.to(torch.float32), M, u_sys, u_mult)  # f32, as in JAX
    # No-resample branch: keep the top-M slots (the resampler's own top-M).
    parents = torch.where(need_resample[:, None], res.parent_indices, res.top_m_indices)
    log_c = torch.where(need_resample, res.log_c.to(dtype), 0.0)
    use_unbiased = need_resample & res.use_unbiased

    p = parents.long()  # indices become int64 only here, at the gathers
    anc = prev_particles.gather(2, p[:, None, :].expand(U, 5, M))
    children, trans_lp, obs_lp = expand_score_and_observe_stacked(params, anc, row_c, row_k)
    log_gamma = torch.where(
        torch.isfinite(trans_lp), trans_lp.to(dtype) + obs_lp.to(dtype), _NEG_INF
    )

    prev_anc = prev_lw.gather(1, p)[:, None, :]  # (U, 1, M)
    w_no_resample = prev_anc + log_gamma
    w_unbiased = -math.log(float(M)) + log_gamma
    # Dead ancestors must give -inf children, not NaN from
    # (-inf) - min(0, log_c + (-inf)).
    w_optimal = torch.where(
        torch.isfinite(prev_anc),
        prev_anc + log_gamma - torch.clamp(log_c[:, None, None] + prev_anc, max=0.0),
        _NEG_INF,
    )
    lw = torch.where(
        need_resample[:, None, None],
        torch.where(use_unbiased[:, None, None], w_unbiased, w_optimal),
        w_no_resample,
    )
    # Flatten (I, M) -> N with n = i*M + m.
    if return_parents:
        return lw.reshape(U, -1), children.reshape(U, 5, -1), p
    return lw.reshape(U, -1), children.reshape(U, 5, -1)


def _renormalise(new_lw):
    """NaN -> -inf; subtract the logsumexp; a unit whose every weight died
    is reset to uniform (counted as degenerate). Returns (lw, shift, degen)."""
    N = new_lw.shape[-1]
    new_lw = torch.where(torch.isnan(new_lw), _NEG_INF, new_lw)
    shift = torch.logsumexp(new_lw, dim=-1)
    degenerate = ~torch.isfinite(shift)
    shift = torch.where(degenerate, 0.0, shift)
    new_lw = torch.where(degenerate[:, None], -math.log(float(N)), new_lw - shift[:, None])
    return new_lw, shift, degenerate


def _draw_uniforms(generator, U, M, device):
    """A site's resampling uniforms: u_sys (U,), then u_mult (U, M)."""
    u_sys = torch.rand((U,), generator=generator, device=device)
    return u_sys, torch.rand((U, M), generator=generator, device=device)


def warm_step(params, emission_control, emission_case, init_lw, init_particles, M, u_sys, u_mult):
    """Site 0 of a warm-started block: _one_step from the previous block's
    final renormalised weights init_lw (U, N) and particles (U, 5, N) int32,
    then _renormalise, as every site of the monolithic filter. Returns
    (lw, particles, shift, degenerate)."""
    lw, parts = _one_step(
        params, emission_control[..., 0, :], emission_case[..., 0, :],
        init_lw, init_particles, M, u_sys, u_mult,
    )
    lw, shift, degenerate = _renormalise(lw)
    return lw, parts, shift, degenerate


def run_filter(
    params: TwoGroupParams,
    emission_control,
    emission_case,
    num_resampled_ancestors: int,
    *,
    n_units: int,
    generator: torch.Generator,
    weight_dtype=torch.float32,
    phantom_regime=None,
    return_history: bool = True,
    init_state=None,
    use_init=None,
) -> FilterResult:
    """Run the filter over the T sites of the (T, R) or (U, T, R) emission
    tables for n_units independent units.

    The carried weights are renormalised every step and the shifts summed
    into the log-normalising constant, which keeps f32 weights safe over
    100k-site segments (the reference's f64 weights are never normalised).

    return_history=False runs the same realisation but keeps only the final
    site: log_weights (U, N) and particles of (U, N).

    Warm start: init_state = (log weights (U, N), particles (U, 5, N) int32),
    the final state of the previous genome block, scores site 0 with
    ``warm_step`` from it instead of the phantom-state initial distribution;
    a degenerate warm step is reset and counted like any other site. The
    generator then draws site 0's uniforms first, and the realisation of a
    block is the monolithic filter's over the same sites. use_init, a (U,)
    bool tensor, picks warm (True) or cold per unit; the phantom regimes of
    the cold start are then drawn after site 0's uniforms.

    History: preallocated (U, T, N) tensors, written row by row IN PLACE
    (f32 weights, int32 durations, int8 flag and regimes). Row 0 is the
    first (or warm) step, rows 1..T-1 the sites after it, the JAX package's
    layout.
    """
    R = params.n_regimes
    M = num_resampled_ancestors
    N = M * num_children(R)
    T = emission_control.shape[-2]
    U = int(n_units)
    dev = params.device

    def cold_start():
        if phantom_regime is None:
            phantom_r = torch.randint(0, R, (U,), generator=generator, device=dev)
        else:
            phantom_r = torch.full((U,), int(phantom_regime), device=dev)
        lw, parts = _first_step(
            params, emission_control, emission_case, N, weight_dtype, phantom_r.to(torch.int32)
        )
        shift = torch.logsumexp(lw, dim=-1)
        return lw - shift[:, None], parts, shift

    n_degen = torch.zeros((U,), dtype=torch.int64, device=dev)
    if init_state is None:
        lw, parts, init_shift = cold_start()
    else:
        init_lw, init_parts = init_state
        u_sys, u_mult = _draw_uniforms(generator, U, M, dev)
        lw, parts, init_shift, warm_degen = warm_step(
            params, emission_control, emission_case, init_lw.to(weight_dtype), init_parts,
            M, u_sys, u_mult,
        )
        if use_init is None:
            n_degen = n_degen + warm_degen
        else:
            cold_lw, cold_parts, cold_shift = cold_start()
            lw = torch.where(use_init[:, None], lw, cold_lw)
            parts = torch.where(use_init[:, None, None], parts, cold_parts)
            init_shift = torch.where(use_init, init_shift, cold_shift)
            n_degen = n_degen + (warm_degen & use_init)

    if return_history:
        hist_lw = torch.empty((U, T, N), dtype=weight_dtype, device=dev)
        hist = State(*(torch.empty((U, T, N), dtype=dt, device=dev) for dt in _HISTORY_DTYPES))
        hist_lw[:, 0] = lw
        for h, f in zip(hist, parts.unbind(1)):
            h[:, 0] = f
    shifts = torch.zeros((U, max(T - 1, 0)), dtype=weight_dtype, device=dev)
    degen = torch.zeros((U, max(T - 1, 0)), dtype=torch.bool, device=dev)

    for t in range(1, T):
        u_sys, u_mult = _draw_uniforms(generator, U, M, dev)
        lw, parts = _one_step(
            params, emission_control[..., t, :], emission_case[..., t, :], lw, parts, M, u_sys, u_mult
        )
        lw, shifts[:, t - 1], degen[:, t - 1] = _renormalise(lw)
        if return_history:
            hist_lw[:, t] = lw  # in place: row t of the preallocated history
            for h, f in zip(hist, parts.unbind(1)):
                h[:, t] = f

    log_z = init_shift + shifts.sum(dim=-1)
    n_degen = n_degen + degen.sum(dim=-1)
    if not return_history:
        return FilterResult(lw, State(*parts.unbind(1)), log_z, n_degen, init_shift, shifts)
    return FilterResult(hist_lw, hist, log_z, n_degen, init_shift, shifts)
