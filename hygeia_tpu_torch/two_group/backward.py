"""Backward simulation over the stored filter history.

Counterpart of hygeia_tpu/two_group/backward.py, batched over U units.
Draw B terminal particles from the final weights, then walk backwards
sampling ancestors from the backward kernel

    B_t(b, n)  propto  w_t^n * f(x_{t+1}^b | x_t^n)

with one Gumbel-max categorical draw per (unit, trajectory) row. The reverse
walk is a Python loop over the sites with no host synchronisation. Dead
slots are excluded by their -inf weights.
"""

from __future__ import annotations

import torch

from hygeia_tpu_torch.ops.hazard import gather_rho
from hygeia_tpu_torch.two_group.model import State, TwoGroupParams
from hygeia_tpu_torch.two_group.proposal import num_children

_NEG_INF = float("-inf")


def _structured_rho(params: TwoGroupParams, cur: State, rc=None, rk=None):
    """Hazards of a filter-history row (..., N) with N = I*M child layout,
    from (..., M) lookups instead of (..., N) ones.

    Every child with duration > 1 carries its ancestor's (regime, duration)
    pair, which the no-change row (slot 0) holds verbatim:
      * d <= 1                 -> rho_table[r, 0]
      * d  > 1 (cont, ctrl-CP) -> table[slot-0 regime, slot-0 duration]
      * case side of the merge row (r_k = anc.r_c, d_k = anc.d_c + 1)
                               -> rho_case[slot-0 r_c, slot-0 d_c]
    rc, rk: the row's regimes as int64 clamped to >= 0 (dead slots, regime
    -1, look up regime 0; their -inf weight masks whatever they get).
    """
    R = params.n_regimes
    I = num_children(R)
    N = cur.d_c.shape[-1]
    if N % I:
        raise ValueError(f"history rows need the N = I*M child layout (N={N}, I={I})")
    M = N // I
    st = params.step_tables()
    if rc is None:
        rc, rk = cur.r_c.long().clamp(min=0), cur.r_k.long().clamp(min=0)
    d_c, d_k = cur.d_c, cur.d_k

    # Slot-0 lookups, all three in one gather: control (d_c0, r_c0), case
    # (d_k0, r_k0), and the case side of the merge row (d_c0, r_c0).
    r3 = torch.stack((rc[..., :M], rk[..., :M], rc[..., :M]), dim=-2)
    d3 = torch.stack((d_c[..., :M], d_k[..., :M], d_c[..., :M]), dim=-2).long()
    deep = st.rho_both[st.which3, r3, (d3 - 1).clamp(0, st.d_max - 1)]  # (..., 3, M)
    a_c, c_cont, c_merge = (x.unsqueeze(-2) for x in deep.unbind(-2))
    sel1 = st.rho_both[st.which, torch.stack((rc, rk), dim=-2), 0]  # duration-1 hazards
    sel_c, sel_k = (x.unflatten(-1, (I, M)) for x in sel1.unbind(-2))

    rho_c = torch.where(d_c.unflatten(-1, (I, M)) <= 1, sel_c, a_c)
    deep_k = torch.where(st.is_merge_row, c_merge, c_cont)
    rho_k = torch.where(d_k.unflatten(-1, (I, M)) <= 1, sel_k, deep_k)
    return rho_c.flatten(-2), rho_k.flatten(-2)


def _backward_logits(params: TwoGroupParams, cur: State, nxt: State, lw_t, *, history_layout=False):
    """Backward-kernel logits lw_t[n] + log f(nxt[b] | cur[n]) as (U, B, N)
    for cur (U, N), nxt (U, B), lw_t (U, N).

    Prev-only factors are computed once at (U, N), next-only ones at (U, B);
    the control transition row is looked up by indexing. Dead slots of cur
    (regime -1) carry lw_t = -inf and get -inf logits. history_layout=True
    takes the hazards from _structured_rho (valid only for filter-history
    rows)."""
    st = params.step_tables()
    zero, neg, log_rm1, log_rm2 = st.zero, st.neg, st.log_rm1, st.log_rm2
    ind = lambda c: torch.where(c, zero, neg)
    rc, rk = cur.r_c.long().clamp(min=0), cur.r_k.long().clamp(min=0)

    if history_layout:
        rho_c, rho_k = _structured_rho(params, cur, rc, rk)
    else:
        rho_c = gather_rho(params.rho_control, cur.d_c, rc)
        rho_k = gather_rho(params.rho_case, cur.d_k, rk)
    rho = torch.stack((rho_c, rho_k), dim=-2)
    log_rho_c, log_rho_k = torch.log(rho).unbind(-2)
    log1m_rho_c, log1m_rho_k = torch.log1p(-rho).unbind(-2)
    gate = torch.minimum(cur.d_k, cur.d_c) >= params.min_duration
    to0, to1 = params.log_p_merged[cur.m.long().clamp(0, 1)].unbind(-1)

    cN = lambda x: x.unsqueeze(-2)  # (U, N) -> (U, 1, N)
    nB = lambda x: x.unsqueeze(-1)  # (U, B) -> (U, B, 1)
    lp_p_ctrl = params.log_p_control[cN(rc), nB(nxt.r_c.long())]  # (U, B, N)

    lp_a = ind((nxt.r_k == nxt.r_c) & (nxt.d_k == nxt.d_c))
    ne_kc = nxt.r_k != nxt.r_c
    lp_unif_not_c = ind(ne_kc) - log_rm1
    nxt_dc1 = nxt.d_c == 1
    nxt_dk1 = nxt.d_k == 1
    lp_b = lp_unif_not_c + ind(nxt_dk1)

    lp_m = torch.where(
        cN(gate),
        torch.where(nB(nxt.m == 0), cN(to0), cN(to1)),
        ind(nB(nxt.m) == cN(cur.m)),
    )
    lp_c = torch.where(
        nB(nxt_dc1),
        cN(log_rho_c) + lp_p_ctrl,
        cN(log1m_rho_c)
        + ind(cN(cur.d_c) == nB(nxt.d_c - 1))
        + ind(cN(cur.r_c) == nB(nxt.r_c)),
    )
    nxt_rc_is_cur_rk = nB(nxt.r_c) == cN(cur.r_k)
    log_n_opts = torch.where(nxt_rc_is_cur_rk, log_rm1, log_rm2)
    lp_unif2 = nB(ind(ne_kc)) + ind(nB(nxt.r_k) != cN(cur.r_k)) - log_n_opts
    lp_cbr = nB(ind(nxt_dk1)) + lp_unif2
    lp_d = torch.where(
        nB(nxt_dk1),
        cN(log_rho_k) + lp_unif2,
        cN(log1m_rho_k)
        + ind(cN(cur.d_k + 1) == nB(nxt.d_k))
        + ind(cN(cur.r_k) == nB(nxt.r_k)),
    )
    in_b = cN(cur.m == 1) & nB(~nxt_dc1)
    in_c = nxt_rc_is_cur_rk & cN(cur.m == 0)
    lp_k = torch.where(
        nB(nxt.m == 1), nB(lp_a), torch.where(in_b, nB(lp_b), torch.where(in_c, lp_cbr, lp_d))
    )
    trans = lp_m + lp_c + lp_k
    return torch.where(
        torch.isfinite(trans) & cN(lw_t > _NEG_INF),
        cN(lw_t).to(trans.dtype) + trans,
        _NEG_INF,
    )


def gumbel(shape, *, generator, dtype=torch.float32, device=None):
    """Standard Gumbel noise -log(-log(u)), u uniform on [tiny, 1), as
    jax.random.gumbel draws it."""
    tiny = torch.finfo(dtype).tiny
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def _categorical_rows(logits, noise):
    """One categorical draw per row of (..., N) logits: Gumbel-max with the
    given noise (argmax takes the first maximum)."""
    return torch.argmax(noise + logits, dim=-1)


def backward_simulation(
    params: TwoGroupParams,
    log_weights,  # (U, T, N) filter weights
    particles: State,  # five (U, T, N) history tensors
    num_simulations: int,
    *,
    generator=None,
    noise=None,
):
    """(U, T, B, 5) int32 sampled smoothing trajectories.

    Gumbel noise comes from ``generator``, or from ``noise(t)`` when given:
    a callable returning the (U, B, N) noise for row t (T-1 for the terminal
    draw), so a test can feed both packages the same numbers."""
    return backward_simulation_conditioned(
        params, log_weights, particles, None, False,
        num_simulations=num_simulations, generator=generator, noise=noise,
    )


def backward_simulation_conditioned(
    params: TwoGroupParams,
    log_weights,  # (U, T, N) filter weights
    particles: State,  # five (U, T, N) history tensors
    terminal_state,  # (U, B, 5) int32: the next block's first-site states
    use_terminal,  # bool, or (U,) bool tensor: condition on terminal_state?
    *,
    num_simulations=None,
    generator=None,
    noise=None,
):
    """Backward simulation of a genome block conditioned on the sampled
    trajectories of the block to its right: (U, T, B, 5) int32.

    Where use_terminal holds, the block's last site is drawn from the
    backward kernel against terminal_state (the next block's states at its
    first site, one site to the right) instead of from the final weights,
    so trajectories join exactly across blocks. Elsewhere the terminal is
    drawn from the final weights, as ``backward_simulation`` does. Noise is
    consumed as in ``backward_simulation``: one (U, B, N) draw per site,
    from T-1 down to 0."""
    U, T, N = log_weights.shape
    B = terminal_state.shape[1] if terminal_state is not None else num_simulations
    dev = log_weights.device
    if noise is None:
        noise = lambda t: gumbel((U, B, N), generator=generator, dtype=log_weights.dtype, device=dev)

    traj = torch.empty((U, T, B, 5), dtype=torch.int32, device=dev)
    last = State(*(f[:, T - 1] for f in particles))
    last_lw = log_weights[:, T - 1]
    eps = noise(T - 1)
    if use_terminal is False:
        idx = _categorical_rows(last_lw[:, None, :], eps)  # (U, B)
    else:
        term = State(*(terminal_state[..., i].to(torch.int32) for i in range(5)))
        logits = _backward_logits(params, last, term, last_lw, history_layout=True)
        idx = _categorical_rows(logits, eps)
        if use_terminal is not True:
            idx = torch.where(use_terminal[:, None], idx, _categorical_rows(last_lw[:, None, :], eps))
    nxt = State(*(f.gather(1, idx).to(torch.int32) for f in last))
    traj[:, T - 1] = torch.stack(nxt, dim=-1)
    for t in range(T - 2, -1, -1):
        cur = State(*(f[:, t] for f in particles))
        logits = _backward_logits(params, cur, nxt, log_weights[:, t], history_layout=True)
        sel = _categorical_rows(logits, noise(t))
        nxt = State(*(f.gather(1, sel).to(torch.int32) for f in cur))
        traj[:, t] = torch.stack(nxt, dim=-1)  # in place, row by row
    return traj


def smoothing_functionals(trajectory, n_regimes):
    """Split probabilities (U, T) and regime marginals (U, T, 2R) from
    (U, T, B, 5) trajectories; columns 0..R-1 control, R..2R-1 case."""
    m = trajectory[..., 0]
    r_c = trajectory[..., 2]
    r_k = trajectory[..., 4]
    mean = lambda x: x.to(torch.float32).mean(dim=-1)
    split = mean(m == 0)
    ctrl = torch.stack([mean(r_c == i) for i in range(n_regimes)], dim=-1)
    case = torch.stack([mean(r_k == i) for i in range(n_regimes)], dim=-1)
    return split, torch.cat([ctrl, case], dim=-1)
