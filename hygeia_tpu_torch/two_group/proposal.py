"""Deterministic proposal expansion for the two-group filter.

Counterpart of hygeia_tpu/two_group/proposal.py. Each of M ancestors gets
I = 2R + R**2 children in a fixed slot layout (flattened particle index
n = i*M + m):

    0            no change point
    1 .. R-1     control CP to regime j, j enumerating {0..R-1} \\ {r_k}
    R .. 2R-2    case CP to regime j, j enumerating {0..R-1} \\ {r_c}
    2R-1         merge
    2R+ i*R + j  state-independent: control regime i, case regime j,
                 merged = (i == j), both durations 1
"""

from __future__ import annotations

import torch

from hygeia_tpu_torch.two_group.model import State


def num_children(n_regimes: int) -> int:
    return 2 * n_regimes + n_regimes * n_regimes


def expand_states(parents: State, n_regimes: int) -> State:
    """All I candidate next states of each ancestor: (..., M) -> (..., I, M)."""
    R = n_regimes
    I = num_children(R)
    dev = parents.m.device
    s = torch.arange(I, dtype=torch.int32, device=dev)[:, None]  # (I, 1)
    a = lambda x: x.to(torch.int32)[..., None, :]  # (..., 1, M)
    m_p, d_c, r_c, d_k, r_k = (a(f) for f in parents)

    is_cont = s == 0
    is_ctrl_cp = (s >= 1) & (s <= R - 1)
    is_case_cp = (s >= R) & (s <= 2 * R - 2)
    is_merge = s == 2 * R - 1
    is_indep = s >= 2 * R

    ctrl_cp_regime = torch.where(s - 1 < r_k, s - 1, s)
    j_case = s - R
    case_cp_regime = torch.where(j_case < r_c, j_case, j_case + 1)
    merge_dur = torch.where(m_p == 0, d_c + 1, 0)
    k = torch.clamp(s - 2 * R, min=0)
    indep_rc = k // R
    indep_rk = k % R
    shape = torch.broadcast_shapes(s.shape, m_p.shape)

    def pick(*pairs):
        out = torch.zeros(shape, dtype=torch.int32, device=dev)
        for cond, val in reversed(pairs):
            out = torch.where(cond, val, out)
        return out.to(torch.int32)

    m = pick(
        (is_cont, m_p), (is_ctrl_cp, 0), (is_case_cp, 0), (is_merge, 1),
        (is_indep, (indep_rc == indep_rk).to(torch.int32)),
    )
    new_d_c = pick(
        (is_cont, d_c + 1), (is_ctrl_cp, 1), (is_case_cp, d_c + 1),
        (is_merge, merge_dur), (is_indep, 1),
    )
    new_r_c = pick(
        (is_cont, r_c), (is_ctrl_cp, ctrl_cp_regime), (is_case_cp, r_c),
        (is_merge, r_c), (is_indep, indep_rc),
    )
    new_d_k = pick(
        (is_cont, d_k + 1), (is_ctrl_cp, d_k + 1), (is_case_cp, 1),
        (is_merge, merge_dur), (is_indep, 1),
    )
    new_r_k = pick(
        (is_cont, r_k), (is_ctrl_cp, r_k), (is_case_cp, case_cp_regime),
        (is_merge, r_c), (is_indep, indep_rk),
    )
    return State(m=m, d_c=new_d_c, r_c=new_r_c, d_k=new_d_k, r_k=new_r_k)


def initial_states(n_regimes: int, device=None) -> State:
    """The R**2 initial proposals: control regime i, case regime j,
    merged = (i == j), durations 1."""
    R = n_regimes
    i = torch.arange(R, dtype=torch.int32, device=device).repeat_interleave(R)
    j = torch.arange(R, dtype=torch.int32, device=device).repeat(R)
    ones = torch.ones_like(i)
    return State(m=(i == j).to(torch.int32), d_c=ones, r_c=i, d_k=ones, r_k=j)
