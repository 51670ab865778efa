"""Case/control (merged/split) change-point regime model on tensors.

Counterpart of hygeia_tpu/two_group/model.py. The latent state is a 5-tuple
of int tensors

    State = (m, d_c, r_c, d_k, r_k)
      m   in {0,1}  : merged indicator (1 = case copies control)
      d_c, r_c      : control (sojourn, regime)
      d_k, r_k      : case (sojourn, regime)

and the transition density is one branch tree of ``torch.where`` over
broadcastable tensors. Hazards come from (R, D_max) tables
(ops/hazard.rho_two_group).

Dead particle slots carry regime -1. The JAX package looks the control
transition row up with one-hot matrix products, which give an all-zero row
for -1; torch indexing would wrap -1 to the last regime instead. Every
regime-keyed lookup here therefore clamps the index and puts -inf (or 0 for
emission rows) on dead slots explicitly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from hygeia_tpu_torch.ops.distributions import inv_logit, mu_sigma_to_alpha_beta
from hygeia_tpu_torch.ops.hazard import gather_rho, rho_two_group

_NEG_INF = float("-inf")


class State(NamedTuple):
    """Batch of latent states; all fields share a broadcastable shape."""

    m: torch.Tensor
    d_c: torch.Tensor
    r_c: torch.Tensor
    d_k: torch.Tensor
    r_k: torch.Tensor


@dataclass
class TwoGroupParams:
    """Model parameters: tensors on one device, in one float dtype."""

    n_regimes: int
    min_duration: int
    mu: torch.Tensor  # (R,)
    sigma: torch.Tensor  # (R,)
    alpha: torch.Tensor  # (R,)
    beta: torch.Tensor  # (R,)
    log_p_control: torch.Tensor  # (R, R) log transition probs, -inf diagonal
    log_p_merged: torch.Tensor  # (2, 2) merged-indicator log transition probs
    rho_control: torch.Tensor  # (R, D_max) control hazard table
    rho_case: torch.Tensor  # (R, D_max) case hazard table

    @property
    def dtype(self):
        return self.rho_case.dtype

    @property
    def device(self):
        return self.rho_case.device

    def step_tables(self):
        """Constants and static index tables of the per-site functions,
        built on the params' device at first use (the params are not
        changed after construction), so that no per-site op copies a
        Python value to the device."""
        st = getattr(self, "_step_tables", None)
        if st is None:
            st = _StepTables(self)
            self._step_tables = st
        return st


class _StepTables:
    def __init__(self, params: TwoGroupParams):
        R = params.n_regimes
        dev, dt = params.device, params.dtype
        f = lambda v: torch.tensor(v, dtype=dt, device=dev)
        i32 = lambda v: torch.as_tensor(v, dtype=torch.int32, device=dev)
        i64 = lambda v: torch.as_tensor(v, dtype=torch.int64, device=dev)
        self.zero, self.neg = f(0.0), f(_NEG_INF)
        self.log_rm1, self.log_rm2 = torch.log(f(R - 1)), torch.log(f(R - 2))
        self.neg_log_rm1 = -self.log_rm1
        self.rho_both = torch.stack([params.rho_control, params.rho_case])  # (2, R, W)
        self.d_max = int(params.rho_case.shape[1])
        self.which = i64([[0], [1]])  # selects the table in rho_both
        self.which3 = i64([[0], [1], [1]])
        I = 2 * R + R * R
        self.is_merge_row = torch.arange(I, device=dev)[:, None] == 2 * R - 1
        self.regs = i32(np.arange(R)[:, None])  # (R, 1)
        self.sA = i32(np.arange(R - 1)[:, None])  # (R-1, 1)
        self.sA1 = self.sA + 1
        k = np.arange(R * R)
        I_rc, I_rk = k // R, k % R
        I_m = (I_rc == I_rk).astype(np.int32)
        self.I_rc, self.I_rk = i64(I_rc), i64(I_rk)
        self.I_m = i32(I_m[:, None])
        self.I_m0, self.I_m1 = self.I_m == 0, self.I_m == 1
        self.emis_row = i64([[0], [1], [1]])  # (row_c[r_c], row_k[r_k], row_k[r_c])
        # Children as rows of a bank: 6 ancestor-valued rows
        # (m, d_c+1, r_c, d_k+1, r_k, merge_dur), R-1 ctrl-CP regimes, R-1
        # case-CP regimes, then the constants 0..R-1.
        B_M, B_DC1, B_RC, B_DK1, B_RK, B_MD = range(6)
        B_CTRL, B_CASE = 6, 6 + (R - 1)
        C = 6 + 2 * (R - 1)  # constant v sits at row C + v
        one = C + 1
        rows = [
            [B_M] + [C] * (2 * (R - 1)) + [one] + [C + v for v in I_m],
            [B_DC1] + [one] * (R - 1) + [B_DC1] * (R - 1) + [B_MD] + [one] * (R * R),
            [B_RC] + [B_CTRL + j for j in range(R - 1)] + [B_RC] * (R - 1) + [B_RC] + [C + v for v in I_rc],
            [B_DK1] + [B_DK1] * (R - 1) + [one] * (R - 1) + [B_MD] + [one] * (R * R),
            [B_RK] + [B_RK] * (R - 1) + [B_CASE + j for j in range(R - 1)] + [B_RC] + [C + v for v in I_rk],
        ]
        self.child_rows = i64(np.concatenate(rows))
        self.bank_consts = i32(np.arange(R)[:, None])  # (R, 1)


def make_params(
    *,
    mu,
    sigma,
    p_softmax_control,
    omega_logit_control,
    omega_case,
    kappa_control,
    kappa_case,
    merge_log_prob,
    split_prob,
    minimum_duration,
    d_max,
    device,
    dtype=torch.float32,
):
    """Build TwoGroupParams the way hygeia_tpu.two_group.model.make_params
    does (run_inference_two_groups.py's construction): rows of the control
    transition matrix renormalised over the off-diagonal, the merged chain
    [[1-pm, pm], [ps, 1-ps]], effective NB success probabilities
    inv_logit(omega_logit_control) and omega_case, hazard tables of depth
    d_max."""
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    mu = as_t(mu)
    sigma = as_t(sigma)
    R = int(mu.shape[0])
    alpha, beta = mu_sigma_to_alpha_beta(mu, sigma)

    logp = as_t(p_softmax_control)
    eye = torch.eye(R, dtype=torch.bool, device=device)
    logp = torch.where(eye, _NEG_INF, logp)
    logp = logp - torch.logsumexp(logp, dim=1, keepdim=True)

    pm = np.exp(merge_log_prob)
    ps = split_prob
    log_p_merged = as_t(np.log(np.array([[1.0 - pm, pm], [ps, 1.0 - ps]])))

    omega_control_eff = inv_logit(as_t(omega_logit_control))
    omega_case_eff = as_t(omega_case) * torch.ones((R,), dtype=dtype, device=device)
    rho_c = rho_two_group(as_t(kappa_control), omega_control_eff, minimum_duration, d_max)
    rho_k = rho_two_group(as_t(kappa_case), omega_case_eff, minimum_duration, d_max)
    return TwoGroupParams(
        n_regimes=R,
        min_duration=int(minimum_duration),
        mu=mu,
        sigma=sigma,
        alpha=alpha,
        beta=beta,
        log_p_control=logp,
        log_p_merged=log_p_merged,
        rho_control=rho_c,
        rho_case=rho_k,
    )


def params_from_numpy(d, *, device, dtype=None):
    """TwoGroupParams from the JAX package's parameters as a dict of numpy
    arrays (``TwoGroupParams._asdict()`` with arrays converted), so a test
    can hand both packages identical tables."""
    t = lambda k: torch.as_tensor(np.asarray(d[k]), dtype=dtype, device=device)
    return TwoGroupParams(
        n_regimes=int(d["n_regimes"]),
        min_duration=int(d["min_duration"]),
        **{k: t(k) for k in ("mu", "sigma", "alpha", "beta", "log_p_control",
                              "log_p_merged", "rho_control", "rho_case")},
    )


def _lookup_log_p(log_p, r_prev, r_nxt):
    """log_p[r_prev, r_nxt] for broadcastable int batches; -inf where either
    regime is out of range (dead slots carry -1)."""
    R = log_p.shape[0]
    live = (r_prev >= 0) & (r_prev < R) & (r_nxt >= 0) & (r_nxt < R)
    val = log_p[r_prev.long().clamp(0, R - 1), r_nxt.long().clamp(0, R - 1)]
    return torch.where(live, val, _NEG_INF)


def _select(row, r):
    """row[r] for a (R,) emission row; 0 for dead regimes (what the JAX
    package's one-hot select gives)."""
    R = row.shape[0]
    live = (r >= 0) & (r < R)
    return torch.where(live, row[r.long().clamp(0, R - 1)], 0.0)


def transition_log_prob(params: TwoGroupParams, prev: State, nxt: State, *, step0=False):
    """log f(nxt | prev), broadcast over State batches.

    step0=True applies the phantom-state overrides: merged probs
    [[0,1],[0,1]] and rho == 1. Branch for branch as the JAX package's
    transition_log_prob (merged chain, control, and the four case
    branches)."""
    R = params.n_regimes
    st = params.step_tables()
    zero, neg, log_rm1, log_rm2 = st.zero, st.neg, st.log_rm1, st.log_rm2
    ind = lambda c: torch.where(c, zero, neg)

    gate = torch.minimum(prev.d_k, prev.d_c) >= params.min_duration
    lpm = params.log_p_merged
    lp_chain = torch.where(
        nxt.m == 0,
        torch.where(prev.m == 0, lpm[0, 0], lpm[1, 0]),
        torch.where(prev.m == 0, lpm[0, 1], lpm[1, 1]),
    )
    lp_identity = ind(nxt.m == prev.m)
    if step0:
        lp_m = ind(nxt.m == 1)
    else:
        lp_m = torch.where(gate, lp_chain, lp_identity)

    if step0:
        rho_c = torch.ones(prev.d_c.shape, dtype=params.dtype, device=params.device)
    else:
        rho_c = gather_rho(params.rho_control, prev.d_c, prev.r_c)
    lp_p_ctrl = _lookup_log_p(params.log_p_control, prev.r_c, nxt.r_c)
    lp_ctrl_cp = torch.log(rho_c) + lp_p_ctrl
    lp_ctrl_cont = (
        torch.log1p(-rho_c)
        + ind(prev.d_c == nxt.d_c - 1)
        + ind(prev.r_c == nxt.r_c)
    )
    lp_c = torch.where(nxt.d_c == 1, lp_ctrl_cp, lp_ctrl_cont)

    if step0:
        rho_k = torch.ones(prev.d_k.shape, dtype=params.dtype, device=params.device)
    else:
        rho_k = gather_rho(params.rho_case, prev.d_k, prev.r_k)

    lp_a = ind((nxt.r_k == nxt.r_c) & (nxt.d_k == nxt.d_c))
    lp_unif_not_c = ind(nxt.r_k != nxt.r_c) - math.log(float(R - 1))
    lp_b = lp_unif_not_c + ind(nxt.d_k == 1)
    log_n_opts = torch.where(nxt.r_c != prev.r_k, log_rm2, log_rm1)
    lp_unif_not_c_not_prev = (
        ind((nxt.r_k != nxt.r_c) & (nxt.r_k != prev.r_k)) - log_n_opts
    )
    lp_c_branch = ind(nxt.d_k == 1) + lp_unif_not_c_not_prev
    lp_d_cp = torch.log(rho_k) + lp_unif_not_c_not_prev
    lp_d_cont = (
        torch.log1p(-rho_k)
        + ind(prev.d_k + 1 == nxt.d_k)
        + ind(prev.r_k == nxt.r_k)
    )
    lp_d = torch.where(nxt.d_k == 1, lp_d_cp, lp_d_cont)

    in_a = nxt.m == 1
    in_b = (prev.m == 1) & (nxt.d_c != 1)
    in_c = (nxt.r_c == prev.r_k) & (prev.m == 0)
    lp_k = torch.where(in_a, lp_a, torch.where(in_b, lp_b, torch.where(in_c, lp_c_branch, lp_d)))
    return lp_m + lp_c + lp_k


def paired_transition_log_prob(params: TwoGroupParams, anc: State, children: State):
    """log f(children[..., i, m] | anc[..., m]) as (..., I, M): children
    paired with their ancestor along M. Ancestor-only factors are computed
    once at (..., M). Dead ancestors (regime -1) give -inf."""
    R = params.n_regimes
    st = params.step_tables()
    zero, neg, log_rm1, log_rm2 = st.zero, st.neg, st.log_rm1, st.log_rm2
    ind = lambda c: torch.where(c, zero, neg)
    aM = lambda x: x[..., None, :]

    rho_c = gather_rho(params.rho_control, anc.d_c, anc.r_c)
    rho_k = gather_rho(params.rho_case, anc.d_k, anc.r_k)
    log_rho_c, log1m_rho_c = torch.log(rho_c), torch.log1p(-rho_c)
    log_rho_k, log1m_rho_k = torch.log(rho_k), torch.log1p(-rho_k)
    gate = torch.minimum(anc.d_k, anc.d_c) >= params.min_duration
    lpm = params.log_p_merged
    to0 = torch.where(anc.m == 0, lpm[0, 0], lpm[1, 0])
    to1 = torch.where(anc.m == 0, lpm[0, 1], lpm[1, 1])

    lp_m = torch.where(
        aM(gate),
        torch.where(children.m == 0, aM(to0), aM(to1)),
        ind(children.m == aM(anc.m)),
    )
    lp_p_ctrl = _lookup_log_p(params.log_p_control, aM(anc.r_c), children.r_c)
    lp_c = torch.where(
        children.d_c == 1,
        aM(log_rho_c) + lp_p_ctrl,
        aM(log1m_rho_c)
        + ind(aM(anc.d_c) == children.d_c - 1)
        + ind(aM(anc.r_c) == children.r_c),
    )

    lp_a = ind((children.r_k == children.r_c) & (children.d_k == children.d_c))
    lp_unif_not_c = ind(children.r_k != children.r_c) - math.log(float(R - 1))
    lp_b = lp_unif_not_c + ind(children.d_k == 1)
    log_n_opts = torch.where(children.r_c != aM(anc.r_k), log_rm2, log_rm1)
    lp_unif2 = (
        ind(children.r_k != children.r_c)
        + ind(children.r_k != aM(anc.r_k))
        - log_n_opts
    )
    lp_cbr = ind(children.d_k == 1) + lp_unif2
    lp_d = torch.where(
        children.d_k == 1,
        aM(log_rho_k) + lp_unif2,
        aM(log1m_rho_k)
        + ind(aM(anc.d_k + 1) == children.d_k)
        + ind(aM(anc.r_k) == children.r_k),
    )
    in_b = aM(anc.m == 1) & (children.d_c != 1)
    in_c = (children.r_c == aM(anc.r_k)) & aM(anc.m == 0)
    lp_k = torch.where(
        children.m == 1, lp_a, torch.where(in_b, lp_b, torch.where(in_c, lp_cbr, lp_d))
    )
    return torch.where(aM(anc.r_c < 0), neg, lp_m + lp_c + lp_k)


def expand_score_and_observe(params: TwoGroupParams, anc: State, row_c, row_k):
    """Proposal expansion, paired transition density and emission lookup in
    one pass: (children State, trans_lp, obs_lp), each (..., I, M), for
    ancestors (..., M) and the site's emission rows row_c, row_k (R,).
    See expand_score_and_observe_stacked."""
    children, trans_lp, obs_lp = expand_score_and_observe_stacked(
        params, torch.stack(tuple(anc), dim=-2).to(torch.int32), row_c, row_k
    )
    return State(*children.unbind(-3)), trans_lp, obs_lp


def expand_score_and_observe_stacked(params: TwoGroupParams, anc, row_c, row_k):
    """expand_score_and_observe on stacked states: anc (..., 5, M) int32 in
    field order (m, d_c, r_c, d_k, r_k); returns children (..., 5, I, M),
    trans_lp and obs_lp (..., I, M).

    The emission rows row_c, row_k are (R,), shared by every unit, or
    (U, R), one row per unit of anc (U, 5, M): units that carry segments
    of their own (the streamed chromosome path).

    Equal to expand_states + paired_transition_log_prob + the emission
    lookup, but uses the static child-slot layout (proposal.py): per slot
    region the branch tree collapses to closed forms over (..., M) ancestor
    factors. Mirrors hygeia_tpu/two_group/model.py:398-620 term for term
    (the same sums in the same order). Written for few tensor ops, since
    the filter runs it once per site: the two hazard lookups are one
    gather, the children are one gather from a bank of candidate rows, and
    dead ancestors (regime -1; their lookups use regime 0) get their -inf
    transition log-probs from one final mask.
    """
    R = params.n_regimes
    st = params.step_tables()
    zero, neg, log_Rm1, log_Rm2 = st.zero, st.neg, st.log_rm1, st.log_rm2
    ind = lambda c: torch.where(c, zero, neg)
    N1 = lambda x: x.unsqueeze(-2)  # (..., M) -> (..., 1, M)
    m_p, d_c, r_c, d_k, r_k = anc.unbind(-2)
    dead = r_c < 0

    # ---- ancestor-only (..., M) -------------------------------------------
    d2, r2 = anc[..., 1::2, :], anc[..., 2::2, :]  # (d_c, d_k), (r_c, r_k)
    r2 = r2.clamp(min=0)
    rho = st.rho_both[st.which, r2, (d2 - 1).clamp(0, st.d_max - 1)]
    log_rho, log1m_rho = torch.log(rho), torch.log1p(-rho)
    log_rho_c, log_rho_k = log_rho.unbind(-2)
    log1m_rho_c, log1m_rho_k = log1m_rho.unbind(-2)
    rc, rk = r2.unbind(-2)
    gate = torch.minimum(d_k, d_c) >= params.min_duration
    to = params.log_p_merged[m_p.clamp(0, 1)]  # (..., M, 2): rows of the merged chain
    to0, to1 = to.unbind(-1)
    rows = params.log_p_control[rc]  # (..., M, R): log_p[r_c[m], x]
    rowsT = rows.transpose(-1, -2)  # (..., R, M)
    diag_lp = rows.gather(-1, rc.unsqueeze(-1)).squeeze(-1)  # log_p[r_c, r_c]
    anc_regimes = torch.stack((rc, rk, rc), dim=-2)  # (..., 3, M)
    if row_c.dim() == 1:
        obs3 = torch.stack((row_c, row_k))[st.emis_row, anc_regimes]
    else:  # (U, R) rows: one gather per unit along R
        obs3 = torch.stack((row_c, row_k), dim=-2)[:, st.emis_row[:, 0]].gather(-1, anc_regimes.long())
    obs_c_anc, obs_k_anck, obs_k_anc = obs3.unbind(-2)

    m0, m1 = m_p == 0, m_p == 1
    rc_eq_rk = r_c == r_k
    dk0 = d_k == 0
    lp_m_cp = torch.where(gate, to0, ind(m0))
    log_rho_c_diag = log_rho_c + diag_lp
    lp_c_cont = torch.where(d_c == 0, log_rho_c_diag, log1m_rho_c)
    lp_k_ctrlcp = torch.where(dk0, neg, log1m_rho_k)

    # ---- cont (slot 0): c = (m_p, d_c+1, r_c, d_k+1, r_k) ----------------
    lp_m_cont = torch.where(gate, torch.where(m0, to0, to1), zero)
    lp_k0 = torch.where(m1, ind(rc_eq_rk & (d_k == d_c)), torch.where(rc_eq_rk, neg, lp_k_ctrlcp))
    lp_cont = lp_m_cont + lp_c_cont + lp_k0
    obs_cont = obs_c_anc + obs_k_anck

    # ---- ctrl-CP (R-1 slots): c = (0, 1, enum\{r_k}, d_k+1, r_k) ---------
    shift_mask = st.sA < N1(r_k)  # (..., R-1, M)
    lp_p_sel = torch.where(shift_mask, rowsT[..., :-1, :], rowsT[..., 1:, :])
    lp_ctrl = N1(lp_m_cp) + (N1(log_rho_c) + lp_p_sel) + N1(lp_k_ctrlcp)
    ctrl_regime = torch.where(shift_mask, st.sA, st.sA1)
    obs_ctrl = torch.where(shift_mask, row_c[..., :-1, None], row_c[..., 1:, None]) + N1(obs_k_anck)

    # ---- case-CP (R-1 slots): c = (0, d_c+1, r_c, 1, enum\{r_c}) ---------
    shift_mask_k = st.sA < N1(r_c)
    case_regime = torch.where(shift_mask_k, st.sA, st.sA1)
    log_n_opts = torch.where(rc_eq_rk, log_Rm1, log_Rm2)
    lp_unif2_case = ind(case_regime != N1(r_k)) - N1(log_n_opts)
    in_b = m1 & (d_c != 0)
    in_c = rc_eq_rk & m0
    lp_k_case = torch.where(
        N1(in_b), st.neg_log_rm1, lp_unif2_case + N1(torch.where(in_c, zero, log_rho_k))
    )
    lp_case = N1(lp_m_cp + lp_c_cont) + lp_k_case
    obs_case = N1(obs_c_anc) + torch.where(shift_mask_k, row_k[..., :-1, None], row_k[..., 1:, None])

    # ---- merge (slot 2R-1): c = (1, md, r_c, md, r_c), md = m_p?0:d_c+1 ---
    d_c1 = d_c + 1
    merge_dur = torch.where(m0, d_c1, 0)
    lp_m_merge = torch.where(gate, to1, ind(m1))
    lp_c_merge = torch.where(m0 & (d_c == 0), log_rho_c_diag, torch.where(m1, neg, log1m_rho_c))
    lp_merge = lp_m_merge + lp_c_merge
    obs_merge = obs_c_anc + obs_k_anc

    # ---- indep (R*R slots): c = (i==j, 1, i, 1, j), static children -------
    lp_m_ind = torch.where(
        N1(gate),
        torch.where(st.I_m0, N1(to0), N1(to1)),
        ind(st.I_m == N1(m_p)),
    )
    lp_c_ind = N1(log_rho_c) + rowsT[..., st.I_rc, :]
    ne_rk = st.regs != N1(r_k)  # (..., R, M): x != r_k
    ne_rk_c = ne_rk[..., st.I_rc, :]
    lp_unif2_ind = ind(ne_rk[..., st.I_rk, :]) - torch.where(ne_rk_c, log_Rm2, log_Rm1)
    lp_k_ind = torch.where(
        st.I_m1, zero, lp_unif2_ind + torch.where(~ne_rk_c & N1(m0), zero, N1(log_rho_k))
    )
    lp_ind = lp_m_ind + lp_c_ind + lp_k_ind
    obs_ind = (row_c[..., st.I_rc] + row_k[..., st.I_rk])[..., None]

    # ---- assemble (..., I, M) -------------------------------------------
    trans_lp = torch.cat([N1(lp_cont), lp_ctrl, lp_case, N1(lp_merge), lp_ind], dim=-2)
    trans_lp = torch.where(N1(dead), neg, trans_lp)
    obs_lp = torch.cat(
        [N1(obs_cont), obs_ctrl, obs_case, N1(obs_merge), obs_ind.expand_as(lp_ind)], dim=-2
    )
    bank = torch.cat(
        [torch.stack((m_p, d_c1, r_c, d_k + 1, r_k, merge_dur), dim=-2),
         ctrl_regime, case_regime, st.bank_consts.expand(*anc.shape[:-2], R, anc.shape[-1])],
        dim=-2,
    )
    children = bank[..., st.child_rows, :].unflatten(-2, (5, -1))
    return children, trans_lp, obs_lp


def phantom_state(phantom_regime, batch_shape=()):
    """The phantom previous state of the initial distribution: merged, zero
    sojourns, regime phantom_regime."""
    r = torch.broadcast_to(torch.as_tensor(phantom_regime).to(torch.int32), batch_shape)
    z = torch.zeros_like(r)
    return State(m=torch.ones_like(r), d_c=z, r_c=r, d_k=z, r_k=r)


def observation_log_prob(emission_control, emission_case, t, state: State):
    """Emission table rows at the particle regimes (dead slots give 0)."""
    return _select(emission_control[t], state.r_c) + _select(emission_case[t], state.r_k)
