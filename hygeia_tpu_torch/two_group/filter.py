"""Deterministic-proposal particle filter for the two-group model.

Counterpart of hygeia_tpu/two_group/filter.py, batched over U units (seeds)
written out as a leading axis. The genome loop is a site step that never
waits for the device: the resampling decision, the weight-update branch
and the degenerate-step reset are tensors under ``torch.where``, with no
``.item()``, no boolean-mask indexing and no ``nonzero``; the site index
is a device tensor the step advances, and the carry is overwritten in
place. On a CUDA device the step runs as a replayed CUDA graph of K sites
(ops/site_graphs.py, the counterpart of JAX's ``lax.scan`` with
``unroll``); on the CPU it runs eagerly. Every draw comes from an explicit
``torch.Generator``.

* _first_step: R**2 initial proposals scored against the phantom-state
  initial distribution, padded to N = M*I with -inf weights and -1
  particles.
* _one_step: resample M ancestors (optimal finite-state, in f32, through
  ops/cuda_resampling), expand, weight update with the optimal
  -min(0, log_c + log W_ancestor) correction. The JAX filter's
  unbiased-resampling switch is not ported: its INFER path always takes the
  optimal resampler, whose own fallback is multinomial.
* filter_site: one site of every filter loop (run_filter's, the warm
  step's, the marginal filter's): _one_step + _renormalise and the carry's
  and history's writes on the CPU; on the card the resampler K1 and then
  K2 (ops/cuda_filter_step), which does the rest in one launch.
* warm start: site 0 scored by filter_site from the previous genome
  block's final (weights, particles) like every later site, so a warm
  block continues the filter exactly (two_group/streaming.py).

The emission tables are (T, R), shared by the units, or (U, T, R), one
segment per unit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from hygeia_tpu_torch.ops.cuda_filter_step import filter_step_cuda
from hygeia_tpu_torch.ops.cuda_resampling import optimal_resampling
from hygeia_tpu_torch.ops.site_graphs import SITES_PER_GRAPH, SiteLoop
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
    res = optimal_resampling(prev_lw.to(torch.float32), M, u_sys, u_mult)  # f32, as in JAX
    return _expand_and_weigh(params, row_c, row_k, prev_lw, prev_particles, M, res, return_parents)


def _expand_and_weigh(params, row_c, row_k, prev_lw, prev_particles, M, res, return_parents=False):
    """_one_step after the resampler, given its ResampleResult ``res`` for
    prev_lw: the plain version of the CUDA filter step K2
    (ops/cuda_filter_step.py) up to the renormalisation."""
    dtype = prev_lw.dtype
    U = prev_lw.shape[0]
    # Normalised-weight contract: the caller renormalises every step, so
    # logsumexp(prev_lw) == 0 and log_z_prev is taken as exactly 0.
    need_resample = torch.isfinite(prev_lw).sum(dim=-1) > M  # (U,)
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


def _draw_uniforms(generator, U, M, device, only=None):
    """A site's resampling uniforms: u_sys (U,), then u_mult (U, M).

    With a list of U generators unit u draws from generator u what a
    one-unit run on it draws; ``only`` (U host bools) then limits the
    draws to the units it marks, and the others get placeholders of 0.5
    (their results are discarded)."""
    if isinstance(generator, (list, tuple)):
        draws = [
            (torch.rand((1,), generator=g, device=device), torch.rand((1, M), generator=g, device=device))
            if only is None or only[u] else
            (torch.full((1,), 0.5, device=device), torch.full((1, M), 0.5, device=device))
            for u, g in enumerate(generator)
        ]
        return torch.cat([us for us, _ in draws]), torch.cat([um for _, um in draws])
    u_sys = torch.rand((U,), generator=generator, device=device)
    return u_sys, torch.rand((U, M), generator=generator, device=device)


def _per_unit(generator, U):
    """Whether ``generator`` is a list of per-unit generators (it must then
    hold U), not one generator for all units."""
    per_unit = isinstance(generator, (list, tuple))
    if per_unit and len(generator) != U:
        raise ValueError(f"{len(generator)} generators for {U} units")
    return per_unit


def _phantom_regimes(generator, U, R, device, phantom_regime=None, only=None):
    """(U,) int64 phantom regimes of a cold start: ``phantom_regime`` for
    every unit when given, else drawn from ``generator`` (one for all
    units, or a list of U: unit u draws from generator u; a unit that
    ``only`` marks False draws nothing and gets a placeholder 0)."""
    per_unit = _per_unit(generator, U)
    if phantom_regime is not None:
        return torch.full((U,), int(phantom_regime), device=device)
    if not per_unit:
        return torch.randint(0, R, (U,), generator=generator, device=device)
    return torch.cat([
        torch.randint(0, R, (1,), generator=g, device=device) if only is None or only[u]
        else torch.zeros((1,), dtype=torch.int64, device=device)
        for u, g in enumerate(generator)
    ])


def filter_site(params, emission_control, emission_case, idx, lw, parts, M, u_sys, u_mult, shifts, degen,
                hist=None, out=None, return_parents=False):
    """One filter site for U units, the step of every filter loop: t is read
    from the device index ``idx`` = (column, t) (int64, (2,)), the weights
    lw (U, N) and particles parts (U, 5, N) int32 are the renormalised
    carry, u_sys (U,) and u_mult (U, M) the site's uniforms. Resamples,
    expands, scores, updates and renormalises; writes the new weights and
    particles into ``out`` = (weights, particles) (default: lw and parts, in
    place), the shift and degenerate flag into column idx[0] of shifts
    (U, C) and degen (U, C), and row t of the history ``hist`` (the weights
    and five fields, (U, T, N) each) when given. Returns the (U, M) int64
    parents with return_parents=True, else None.

    CPU tensors take the plain version, ``_one_step`` + ``_renormalise``;
    a CUDA tensor takes the resampler K1 and then K2
    (ops/cuda_filter_step.py), with f32 weights and tables, or the call
    raises. The emission tables are (T, R), shared by the units, or
    (U, T, R)."""
    out_lw, out_parts = (lw, parts) if out is None else out
    if lw.device.type != "cpu":
        res = optimal_resampling(lw, M, u_sys, u_mult)
        parents = None
        if return_parents:
            parents = torch.empty(res.parent_indices.shape, dtype=torch.int64, device=lw.device)
        st = params.step_tables()
        filter_step_cuda(emission_control, emission_case, idx, lw, parts, res, M, st.rho_both,
                         params.log_p_control, params.log_p_merged, params.min_duration, out_lw,
                         out_parts, shifts, degen, hist, parents)
        return parents
    col, t = idx[:1], idx[1:]
    row_c = emission_control.index_select(-2, t).squeeze(-2)
    row_k = emission_case.index_select(-2, t).squeeze(-2)
    new_lw, new_parts, *parents = _one_step(params, row_c, row_k, lw, parts, M, u_sys, u_mult,
                                            return_parents=return_parents)
    new_lw, shift, degenerate = _renormalise(new_lw)
    shifts.index_copy_(1, col, shift[:, None])
    degen.index_copy_(1, col, degenerate[:, None])
    if hist is not None:
        hist[0].index_copy_(1, t, new_lw[:, None])
        for h, f in zip(hist[1:], new_parts.unbind(1)):
            h.index_copy_(1, t, f[:, None].to(h.dtype))
    out_lw.copy_(new_lw)
    out_parts.copy_(new_parts)
    return parents[0] if return_parents else None


def warm_step(params, emission_control, emission_case, init_lw, init_particles, M, u_sys, u_mult):
    """Site 0 of a warm-started block: ``filter_site`` at t = 0 from the
    previous block's final renormalised weights init_lw (U, N) and
    particles (U, 5, N) int32, as every site of the monolithic filter.
    Returns (lw, particles, shift, degenerate)."""
    U, dev = init_lw.shape[0], init_lw.device
    lw, parts = init_lw.contiguous(), init_particles.contiguous()
    out = (torch.empty_like(lw), torch.empty_like(parts))
    shift = torch.empty((U, 1), dtype=lw.dtype, device=dev)
    degenerate = torch.empty((U, 1), dtype=torch.bool, device=dev)
    idx = torch.zeros((2,), dtype=torch.int64, device=dev)
    filter_site(params, emission_control, emission_case, idx, lw, parts, M, u_sys, u_mult, shift,
                degenerate, out=out)
    return out[0], out[1], shift[:, 0], degenerate[:, 0]


def run_filter(
    params: TwoGroupParams,
    emission_control,
    emission_case,
    num_resampled_ancestors: int,
    *,
    n_units: int,
    generator,
    weight_dtype=torch.float32,
    phantom_regime=None,
    return_history: bool = True,
    init_state=None,
    use_init=None,
    sites_per_graph: int = SITES_PER_GRAPH,
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
    bool tensor (or U host bools), picks warm (True) or cold per unit; the
    phantom regimes of the cold start are then drawn after site 0's
    uniforms.

    ``generator`` is one torch.Generator for all units, or a list of U,
    one a unit: unit u then draws from generator u exactly what a one-unit
    run on it draws, whatever the other units are; with use_init a warm
    unit draws what a warm run draws and a cold unit what a cold run draws
    (site 0's uniforms of a cold unit and the phantom regime of a warm one
    are placeholders, not draws).

    History: preallocated (U, T, N) tensors, written row by row IN PLACE
    (f32 weights, int32 durations, int8 flag and regimes). Row 0 is the
    first (or warm) step, rows 1..T-1 the sites after it, the JAX package's
    layout.

    Sites 1..T-1 run as ``_site_step``: on a CUDA device through CUDA
    graphs of ``sites_per_graph`` sites (0: eagerly, only to compare the
    two; the same bits either way), on the CPU eagerly. The cold, warm and
    ``use_init`` starts run eagerly before the loop.
    """
    R = params.n_regimes
    M = num_resampled_ancestors
    N = M * num_children(R)
    T = emission_control.shape[-2]
    U = int(n_units)
    dev = params.device

    per_unit = _per_unit(generator, U)

    def cold_start(only=None):
        phantom_r = _phantom_regimes(generator, U, R, dev, phantom_regime, only)
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
        warm = None  # host flags, needed only to pick the units that draw
        if use_init is not None and per_unit:
            warm = use_init.tolist() if torch.is_tensor(use_init) else [bool(v) for v in use_init]
        if use_init is not None:
            use_init = torch.as_tensor(use_init, dtype=torch.bool, device=dev)
        u_sys, u_mult = _draw_uniforms(generator, U, M, dev, only=warm)
        lw, parts, init_shift, warm_degen = warm_step(
            params, emission_control, emission_case, init_lw.to(weight_dtype), init_parts,
            M, u_sys, u_mult,
        )
        if use_init is None:
            n_degen = n_degen + warm_degen
        else:
            cold_lw, cold_parts, cold_shift = cold_start(None if warm is None else [not w for w in warm])
            lw = torch.where(use_init[:, None], lw, cold_lw)
            parts = torch.where(use_init[:, None, None], parts, cold_parts)
            init_shift = torch.where(use_init, init_shift, cold_shift)
            n_degen = n_degen + (warm_degen & use_init)

    hist = None
    if return_history:
        hist_lw = torch.empty((U, T, N), dtype=weight_dtype, device=dev)
        hist = (hist_lw, *(torch.empty((U, T, N), dtype=dt, device=dev) for dt in _HISTORY_DTYPES))
        hist_lw[:, 0] = lw
        for h, f in zip(hist[1:], parts.unbind(1)):
            h[:, 0] = f
    shifts = torch.zeros((U, max(T - 1, 0)), dtype=weight_dtype, device=dev)
    degen = torch.zeros((U, max(T - 1, 0)), dtype=torch.bool, device=dev)

    # The carry: the step overwrites these in place, site after site.
    lw, parts = (x.clone(memory_format=torch.contiguous_format) for x in (lw, parts))
    idx = torch.tensor([0, 1], dtype=torch.int64, device=dev)  # (t - 1, t) of the next site
    step = lambda: _site_step(params, emission_control, emission_case, M, generator, U,
                              idx, lw, parts, shifts, degen, hist)
    with SiteLoop(dev, sites_per_graph, generator) as loop:
        loop.run(step, T - 1)

    log_z = init_shift + shifts.sum(dim=-1)
    n_degen = n_degen + degen.sum(dim=-1)
    if not return_history:
        return FilterResult(lw, State(*parts.unbind(1)), log_z, n_degen, init_shift, shifts)
    return FilterResult(hist[0], State(*hist[1:]), log_z, n_degen, init_shift, shifts)


def _site_step(params, emission_control, emission_case, M, generator, U, idx, lw, parts,
               shifts, degen, hist):
    """One site t of the filter's loop, replayable as a CUDA graph: t is
    read from the device index ``idx`` = (t - 1, t), which the step then
    advances; the carry ``lw`` (U, N) and ``parts`` (U, 5, N), the
    shifts' and degenerate flags' column t - 1 and the history's row t are
    written in place (``filter_site``)."""
    u_sys, u_mult = _draw_uniforms(generator, U, M, lw.device)
    filter_site(params, emission_control, emission_case, idx, lw, parts, M, u_sys, u_mult, shifts, degen,
                hist)
    idx.add_(1)
