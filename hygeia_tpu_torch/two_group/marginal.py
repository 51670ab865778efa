"""Marginal filter: two-group filtering with adaptive-lag online marginal
smoothing, in constant memory in T.

Counterpart of hygeia_tpu/two_group/marginal.py, batched over U units
(seeds) as a leading axis. Instead of storing the (T, N) history for
backward simulation, each unit carries smoothing statistics psi for a ring
buffer of ``smoothing_window`` pending times through the backward kernels

    B_t(n, j) propto w_{t-1}^j * f(x_t^n | x_{t-1}^j),

and finalises a time's estimates once the filtered variances of all its
test functions are below ``epsilon`` (or at the last site). A time pushed
out of a full buffer is finalised early and counted in ``spill_count``.

Test functions: F = 1 + 2R columns, the split indicator (m == 0) and the R
control and R case regime indicators.

psi is carried over the compact column layout (C = 2R*M + R*R columns in
place of N = 2R*M + R*R*M): the R*R independent proposal children are the
same states for every ancestor, so their psi columns are equal and one
column a class holds them. ``_structured_psi_update_compact`` applies the
backward kernel without building the (N, N) grid: every child row factors
into per-predecessor scalars, equality masks keyed on the child's ancestor
and at most one rank-R regime factor, so the update is one
(S*F + 1, C) x (C, 3M + 2MR + R*R) matrix product per unit (``torch.matmul``;
the JAX package computes it outside any Pallas kernel too).

The site step is the filter's ``filter_site``: on the card the resampler
K1 (ops/cuda_resampling) and the filter step K2 (ops/cuda_filter_step),
one launch each a site for every unit of the call. The site
loop is a step that reads its site from a device index and writes its
carry in place, so on a CUDA device it replays as CUDA graphs
(ops/site_graphs.py, the counterpart of the JAX module's ``lax.scan``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hygeia_tpu_torch.ops.site_graphs import SITES_PER_GRAPH, SiteLoop
from hygeia_tpu_torch.two_group.backward import _structured_rho
from hygeia_tpu_torch.two_group.filter import _draw_uniforms, _first_step, _phantom_regimes, filter_site
from hygeia_tpu_torch.two_group.model import State, TwoGroupParams
from hygeia_tpu_torch.two_group.proposal import num_children


class MarginalResult(NamedTuple):
    functionals: torch.Tensor  # (U, T, 1 + 2R): split prob, control regimes, case regimes
    valid: torch.Tensor  # (U, T) bool
    log_normalizing_constant: torch.Tensor  # (U,)
    spill_count: torch.Tensor  # (U,) times force-finalised by a full buffer
    degenerate_steps: torch.Tensor  # (U,) steps where every weight died (reset to uniform)


def _test_functions(state: State, n_regimes):
    """(..., F, N) indicators: split, control regimes, case regimes."""
    regs = torch.arange(n_regimes, device=state.m.device)[:, None]
    split = (state.m == 0).to(torch.float32).unsqueeze(-2)
    ctrl = (state.r_c.unsqueeze(-2) == regs).to(torch.float32)
    case = (state.r_k.unsqueeze(-2) == regs).to(torch.float32)
    return torch.cat([split, ctrl, case], dim=-2)


def num_compact_columns(R, M):
    return 2 * R * M + R * R


def _compact_rep(f, R, M):
    """(..., N) per-particle values -> the (..., C) compact layout: the first
    2R*M columns as they are, then each independent class's m = 0 member."""
    C0 = 2 * R * M
    return torch.cat([f[..., :C0], f[..., C0:].unflatten(-1, (R * R, M))[..., 0]], dim=-1)


def _compact_sum(f, R, M):
    """(..., N) weights -> (..., C): each independent class summed."""
    C0 = 2 * R * M
    return torch.cat([f[..., :C0], f[..., C0:].unflatten(-1, (R * R, M)).sum(-1)], dim=-1)


def _structured_psi_update(params: TwoGroupParams, prev: State, lw_prev, anc: State, psi):
    """psi @ B_norm^T over the full (N,) column layout, for prev (U, N),
    lw_prev (U, N), anc (U, M), psi (U, S, F, N): psi compacted by a
    class-weighted mean, the compact update, and re-expanded. The tests'
    oracle for the compact update; the filter itself calls the compact one."""
    R = params.n_regimes
    M = anc.m.shape[-1]
    C0 = 2 * R * M
    f32 = psi.dtype
    w = torch.where(torch.isfinite(lw_prev), torch.exp(lw_prev), 0.0).to(f32)
    wt = w[..., C0:].unflatten(-1, (R * R, M))  # (U, RR, M)
    wsum = wt.sum(-1)
    tail = torch.einsum("usfkm,ukm->usfk", psi[..., C0:].unflatten(-1, (R * R, M)), wt)
    tail = torch.where(wsum[:, None, None] > 0.0,
                       tail / torch.where(wsum > 0.0, wsum, 1.0)[:, None, None], 0.0)
    out_c = _structured_psi_update_compact(params, prev, w, anc, torch.cat([psi[..., :C0], tail], -1))
    ind = out_c[..., C0:, None].expand(*out_c.shape[:-1], R * R, M).flatten(-2)
    return torch.cat([out_c[..., :C0], ind], dim=-1)


def _structured_psi_update_compact(params: TwoGroupParams, prev: State, w_full, anc: State, psi_c):
    """psi_c @ B_norm^T without the (N, N) backward kernel, over the compact
    layout: prev (U, N) the previous particles, w_full (U, N) their
    normalised weights, anc (U, M) the resampled ancestors, psi_c
    (U, S, F, C). The child slots, in the (I, M) layout n = i*M + m:

      cont (slot 0)      predecessors match the ancestor's control pair;
                         unmerged children also its case pair;
      ctrl-CP (R-1)      control side over every predecessor
                         (rho_c_j * P[r_c_j, r']), case side pinned to the
                         ancestor: (M*R) columns, P applied after the product;
      case-CP (R-1)      control match, and a case factor through
                         (m_j, rho_k_j, r_k_j): merged -> 1/(R-1), unmerged
                         -> rho_k_j 1[q != r_k_j]/(R-2), the indicator as the
                         one-hot sum less the q column;
      merge (2R-1)       control match and the chain to merged (dead for
                         merged ancestors);
      indep (R*R)        static states, built densely.

    One (S*F + 1, C) x (C, 3M + 2MR + R*R) product per unit; the ones row
    gives each child's denominator, and a child with denominator 0 (dead)
    gets psi 0."""
    R = params.n_regimes
    U, M = anc.m.shape
    S, F, C = psi_c.shape[1:]
    SF, SFp = S * F, S * F + 1
    f32 = psi_c.dtype
    dev = psi_c.device

    rho_c_f, rho_k_f = _structured_rho(params, prev)  # (U, N)
    rho_c = _compact_rep(rho_c_f.to(f32), R, M)
    rho_k = _compact_rep(rho_k_f.to(f32), R, M)
    w = _compact_sum(w_full.to(f32), R, M)
    pc = State(*(_compact_rep(f.long(), R, M) for f in prev))  # (U, C)
    ac = State(*(f.long() for f in anc))  # (U, M)
    one_m_rc = 1.0 - rho_c
    gate = torch.minimum(pc.d_k, pc.d_c) >= params.min_duration
    pm = torch.exp(params.log_p_merged).to(f32)
    m0 = (pc.m == 0).to(f32)
    m1 = (pc.m == 1).to(f32)
    to0 = torch.where(pc.m == 0, pm[0, 0], pm[1, 0])
    to1 = torch.where(pc.m == 0, pm[0, 1], pm[1, 1])
    chain0 = torch.where(gate, to0, m0)
    chain1 = torch.where(gate, to1, m1)
    regs = torch.arange(R, device=dev)
    oh_rc = (pc.r_c[..., None] == regs).to(f32)  # (U, C, R)
    oh_rk = (pc.r_k[..., None] == regs).to(f32)
    lp = params.log_p_control
    P = torch.where(torch.isfinite(lp), torch.exp(lp), 0.0).to(f32)
    Prow = oh_rc @ P  # (U, C, R): P[r_c_j, :]

    maskC = ((pc.d_c[:, None, :] == ac.d_c[:, :, None])
             & (pc.r_c[:, None, :] == ac.r_c[:, :, None])).to(f32)  # (U, M, C)
    maskK = ((pc.d_k[:, None, :] == ac.d_k[:, :, None])
             & (pc.r_k[:, None, :] == ac.r_k[:, :, None])).to(f32)

    row = lambda x: x[:, None, :]  # (U, C) -> (U, 1, C)
    col_cont = row(w * one_m_rc) * maskC * torch.where(
        (ac.m == 1)[:, :, None], row(chain1), row(chain0 * (1.0 - rho_k) * m0) * maskK)
    col_merge = row(w * chain1 * one_m_rc) * maskC * (ac.m == 0)[:, :, None].to(f32)
    cC = w * chain0 * rho_c * (1.0 - rho_k)
    colH1 = (cC[:, None, None, :] * maskK[:, :, None, :]) * oh_rc.transpose(1, 2)[:, None]  # (U, M, R, C)
    # R - 2 guards R == 2 (the indicator is then identically 0).
    Rm2 = float(max(R - 2, 1))
    colT1 = row(w * chain0 * one_m_rc * m1 / float(R - 1)) * maskC
    a2 = w * chain0 * one_m_rc * rho_k * m0 / Rm2
    colH2 = (a2[:, None, None, :] * maskC[:, :, None, :]) * oh_rk.transpose(1, 2)[:, None]

    kk = torch.arange(R * R, device=dev)
    i_idx, q_idx = kk // R, kk % R
    Prow_i = Prow.transpose(1, 2)[:, i_idx]  # (U, RR, C)
    eq_rk_i = oh_rk.transpose(1, 2)[:, i_idx]  # 1[r_k_j == i]
    neq_rk_q = 1.0 - oh_rk.transpose(1, 2)[:, q_idx]
    n_opts = torch.where(eq_rk_i == 1.0, float(R - 1), Rm2)
    casefac = torch.where((row(m0) == 1.0) & (eq_rk_i == 1.0), 1.0 / float(R - 1),
                          row(rho_k) * neq_rk_q / n_opts)
    col_ind = row(w * rho_c) * Prow_i * torch.where(
        (i_idx == q_idx)[None, :, None], row(chain1), row(chain0) * casefac)

    G = torch.cat([col_cont, colH1.reshape(U, M * R, C), colT1, colH2.reshape(U, M * R, C),
                   col_merge, col_ind], dim=1)  # (U, Cg, C)
    psi_aug = torch.cat([psi_c.reshape(U, SF, C), torch.ones((U, 1, C), dtype=f32, device=dev)], dim=1)
    Y = psi_aug @ G.transpose(1, 2)  # (U, SFp, Cg)

    off = 0
    y_cont = Y[..., off:off + M]; off += M
    H1 = Y[..., off:off + M * R].reshape(U, SFp, M, R); off += M * R
    yT1 = Y[..., off:off + M]; off += M
    H2 = Y[..., off:off + M * R].reshape(U, SFp, M, R); off += M * R
    y_merge = Y[..., off:off + M]; off += M
    y_ind = Y[..., off:off + R * R]

    s_idx = torch.arange(R - 1, device=dev)[None, :, None]  # (1, R-1, 1)
    # ctrl-CP: the P[., r'(s, m)] factor after the product (one-hot, exact).
    ctrl_regime = torch.where(s_idx < ac.r_k[:, None, :], s_idx, s_idx + 1)  # (U, R-1, M)
    oh_ctrl = (ctrl_regime[..., None] == regs).to(f32)  # (U, R-1, M, R)
    P_sel = torch.einsum("usmr,xr->usmx", oh_ctrl, P)
    y_ctrl = torch.einsum("uzmx,usmx->uzsm", H1, P_sel)
    # case-CP: T1 + sum_y H2 - H2 at y = q(s, m).
    case_regime = torch.where(s_idx < ac.r_c[:, None, :], s_idx, s_idx + 1)
    oh_case = (case_regime[..., None] == regs).to(f32)
    H2_sel = torch.einsum("uzmy,usmy->uzsm", H2, oh_case)
    h2_sum = H2[..., 0]
    for y in range(1, R):  # left to right, as XLA sums R terms: the difference below cancels
        h2_sum = h2_sum + H2[..., y]
    y_case = (yT1 + h2_sum)[:, :, None, :] - H2_sel

    num = torch.cat([
        torch.cat([y_cont[:, :, None, :], y_ctrl, y_case, y_merge[:, :, None, :]], dim=2)
        .reshape(U, SFp, 2 * R * M),
        y_ind,
    ], dim=2)  # (U, SFp, C)
    denom = num[:, -1:]
    psi_new = torch.where(denom > 0.0, num[:, :-1] / torch.where(denom > 0.0, denom, 1.0), 0.0)
    return psi_new.reshape(psi_c.shape)


def run_marginal_filter(
    params: TwoGroupParams,
    emission_control,
    emission_case,
    num_resampled_ancestors: int,
    *,
    n_units: int,
    generator: torch.Generator = None,
    uniforms=None,
    epsilon=0.01,
    smoothing_window=64,
    weight_dtype=torch.float32,
    phantom_regime=None,
    sites_per_graph: int = SITES_PER_GRAPH,
) -> MarginalResult:
    """The marginal filter over the T sites of the (T, R) or (U, T, R)
    emission tables, for n_units units in one site loop (one resampler
    launch a site serves them all).

    Randomness: the phantom regimes (unless ``phantom_regime`` is given)
    and each site's uniforms come from ``generator``, in the order
    ``run_filter`` draws them (one generator, or a list of U: unit u then
    draws from generator u); or ``uniforms`` = (u_sys (U, T-1),
    u_mult (U, T-1, M)) gives every site's. The carried weights are
    renormalised every site (an all-dead site is reset to uniform and
    counted, as in ``run_filter``) and the shifts summed into logZ.

    Sites 1..T-2 run as ``_marginal_step``: on a CUDA device through CUDA
    graphs of ``sites_per_graph`` sites (0: eagerly, only to compare the
    two; the same bits either way), on the CPU eagerly. Site 0 and the
    last site (where every pending time finalises) run eagerly."""
    R = params.n_regimes
    M = num_resampled_ancestors
    N = M * num_children(R)
    T = emission_control.shape[-2]
    U = int(n_units)
    F = 1 + 2 * R
    S = int(smoothing_window)
    C = num_compact_columns(R, M)
    dev = params.device
    f32 = torch.float32
    if uniforms is None and generator is None:
        raise ValueError("run_marginal_filter needs a generator or injected uniforms")

    phantom_r = _phantom_regimes(generator, U, R, dev, phantom_regime)
    lw, parts = _first_step(params, emission_control, emission_case, N, weight_dtype,
                            phantom_r.to(torch.int32))
    shift0 = torch.logsumexp(lw, dim=-1)
    lw = lw - shift0[:, None]

    state0 = State(*(_compact_rep(f, R, M) for f in parts.unbind(1)))
    psi = torch.zeros((U, S, F, C), dtype=f32, device=dev)
    psi[:, 0] = _test_functions(state0, R)
    psi_time = torch.full((U, S), T, dtype=torch.int64, device=dev)
    psi_time[:, 0] = 0
    psi_valid = torch.zeros((U, S), dtype=torch.bool, device=dev)
    psi_valid[:, 0] = True
    out = torch.zeros((U, T + 1, F), dtype=f32, device=dev)
    out_valid = torch.zeros((U, T + 1), dtype=torch.bool, device=dev)
    spill = torch.zeros((U,), dtype=torch.int64, device=dev)
    shifts = torch.zeros((U, max(T - 1, 0)), dtype=weight_dtype, device=dev)
    degen = torch.zeros((U, max(T - 1, 0)), dtype=torch.bool, device=dev)

    # The carry: the step overwrites these in place, site after site.
    carry = _MarginalCarry(lw, parts, psi, psi_time, psi_valid, out, out_valid, spill, shifts,
                           degen, torch.tensor([0, 1], dtype=torch.int64, device=dev),
                           torch.ones((), dtype=torch.bool, device=dev))
    step = lambda last=False: _marginal_step(params, emission_control, emission_case, M, generator, uniforms,
                                             epsilon, carry, last)
    with SiteLoop(dev, sites_per_graph, generator) as loop:
        loop.run(step, T - 2)
        if T > 1:
            step(last=True)

    return MarginalResult(
        functionals=out[:, :T],
        valid=out_valid[:, :T],
        log_normalizing_constant=shift0.to(weight_dtype) + shifts.sum(dim=-1),
        spill_count=spill,
        degenerate_steps=degen.sum(dim=-1),
    )


class _MarginalCarry(NamedTuple):
    """What the marginal filter's site step reads and overwrites in place."""

    lw: torch.Tensor  # (U, N) renormalised log weights
    parts: torch.Tensor  # (U, 5, N) int32 particles
    psi: torch.Tensor  # (U, S, F, C) smoothing statistics of the pending times
    psi_time: torch.Tensor  # (U, S) int64 their times (T: a free slot)
    psi_valid: torch.Tensor  # (U, S) bool
    out: torch.Tensor  # (U, T + 1, F) finalised estimates
    out_valid: torch.Tensor  # (U, T + 1) bool
    spill: torch.Tensor  # (U,) int64
    shifts: torch.Tensor  # (U, T - 1)
    degen: torch.Tensor  # (U, T - 1) bool
    idx: torch.Tensor  # (2,) int64: (t - 1, t) of the next site
    true: torch.Tensor  # () bool: a value written by index (a Python True is a host copy)


def _marginal_step(params, emission_control, emission_case, M, generator, uniforms, epsilon,
                   c: _MarginalCarry, last=False):
    """One site t of the marginal filter's loop, replayable as a CUDA graph:
    t is read from the device index ``c.idx`` = (t - 1, t), which the step
    then advances; every tensor of the carry is written in place. ``last``:
    the last site, where every pending time finalises."""
    R = params.n_regimes
    U, S = c.psi_time.shape
    T = c.out.shape[1] - 1
    f32 = c.psi.dtype
    t_prev, t = c.idx[:1], c.idx[1:]
    if uniforms is None:
        u_sys, u_mult = _draw_uniforms(generator, U, M, c.lw.device)
    else:
        u_sys = uniforms[0].index_select(1, t_prev)[:, 0]
        u_mult = uniforms[1].index_select(1, t_prev)[:, 0]
    new_lw, new_parts = torch.empty_like(c.lw), torch.empty_like(c.parts)
    parents = filter_site(params, emission_control, emission_case, c.idx, c.lw, c.parts, M, u_sys, u_mult,
                          c.shifts, c.degen, out=(new_lw, new_parts), return_parents=True)
    w_self = _compact_sum(torch.where(torch.isfinite(new_lw), torch.exp(new_lw), 0.0).to(f32), R, M)
    new_cols = State(*(_compact_rep(f, R, M) for f in new_parts.unbind(1)))

    prev = State(*c.parts.unbind(1))
    anc = State(*(f.gather(1, parents) for f in prev))
    psi_in = torch.where(c.psi_valid[:, :, None, None], c.psi, 0.0)
    w_prev = torch.where(torch.isfinite(c.lw), torch.exp(c.lw), 0.0).to(f32)
    psi = _structured_psi_update_compact(params, prev, w_prev, anc, psi_in)

    # Insert time t: a free slot, else force-finalise the oldest.
    units = torch.arange(U, device=c.lw.device)
    psi_valid, psi_time, out, out_valid = c.psi_valid, c.psi_time, c.out, c.out_valid
    has_free = (~psi_valid).any(dim=1)
    ins = torch.where(has_free, (~psi_valid).to(torch.int8).argmax(dim=1),
                      torch.where(psi_valid, psi_time, T + 1).argmin(dim=1))
    means_ins = torch.einsum("ufn,un->uf", psi[units, ins], w_self)
    c.spill.add_((~has_free).to(torch.int64))
    victim = psi_time[units, ins]
    out[units, victim] = torch.where(has_free[:, None], out[units, victim], means_ins)
    out_valid[units, victim] = out_valid[units, victim] | ~has_free
    psi[units, ins] = _test_functions(new_cols, R)
    psi_time.index_put_((units, ins), t.expand(U))
    psi_valid.index_put_((units, ins), c.true.expand(U))

    # Finalise: every filtered variance below epsilon, or the last site.
    means = torch.einsum("usfn,un->usf", psi, w_self)
    sumsq = torch.einsum("usfn,un->usf", psi * psi, w_self)
    var = sumsq - means * means
    fin = psi_valid & ((var < epsilon).all(dim=2) | last)
    rows = units[:, None].expand(U, S)
    out[rows, psi_time] = torch.where(fin[..., None], means, out[rows, psi_time])
    out_valid[rows, psi_time] = out_valid[rows, psi_time] | fin
    psi_valid.copy_(psi_valid & ~fin)
    c.psi.copy_(psi)
    c.lw.copy_(new_lw)
    c.parts.copy_(new_parts)
    c.idx.add_(1)
