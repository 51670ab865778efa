"""Plain reference of hygeia's two-group model, the INFER stage's model.

Written from the model's description (the upstream TF model's
case_control_regime_model.py and case_control_distributions.py, as
hygeia's own NumPy re-creation states them) in plain PyTorch, float64 by
default. It imports nothing of the program: it takes the read counts, the
theta file's P and omega and the configuration's settings, and works out
the emission tables, the hazard tables and every transition density
itself.

States are (..., 5) int64 tensors in field order (m, d_c, r_c, d_k, r_k):
m = 1 when the case group copies the control group (merged), d the
sojourn and r the regime of each group. The particle history stores
children slot-major, n = i * M + m over I = 2R + R**2 slots an ancestor:

    0            no change point
    1 .. R-1     control change point to j, j enumerating {0..R-1} minus r_k
    R .. 2R-2    case change point to j, j enumerating {0..R-1} minus r_c
    2R-1         merge
    2R + i*R + j the state-independent pair (i == j, 1, i, 1, j)

Precision of the stated model (float32). The hazard's survival function
S(k - 1) = P(K >= k) of the negative binomial sojourn underflows float32 in
the deep tail, and the model then takes the guard value 0.1 (the upstream
model's ``fixed_value_inf``). The reference computes S in float64 and
applies the guard where float32 loses it: where S, or the prefactor of the
continued fraction that evaluates S in the stated precision (the
regularised incomplete beta I_omega(k, kappa)), lies below float32's
smallest normal number.

``step_weights`` follows the program's filter one site at a time from the
program's own state (its normalised weights and particles at t - 1), which
is the only way to compare a particle filter whose resampling draws differ
from run to run: given that state, the weights at t are determined up to
which ancestors the random part of the resampling picked, and the
ancestors are read off the children's states. Which ancestors were picked
is judged apart: ``resampling_faults`` (as many as optimal resampling
keeps, every particle it must keep kept) and ``systematic_mismatch`` (the
rest one systematic draw). The backward pass's draws are judged by their
randomised probability integral transform under the reference's kernel
(``backward_pit``, ``ks_sqrt_n``).
"""

from __future__ import annotations

import math

import torch

FLT_MIN = 2.0 ** -126
GUARD = 0.1
_NEG = float("-inf")


def alpha_beta(mu, sigma):
    """Beta shape parameters of the regimes' (mean, sd)."""
    nu = mu * (1.0 - mu) / sigma**2 - 1.0
    return mu * nu, (1.0 - mu) * nu


def emission_table(n_meth, n_total, alpha, beta, dtype=torch.float64):
    """(T, R): sum over samples of log BetaBinomial(y; n, alpha_r, beta_r);
    a site with no reads adds 0."""
    y = torch.as_tensor(n_meth).to(dtype)[:, :, None]
    n = torch.as_tensor(n_total).to(dtype)[:, :, None]
    a = torch.as_tensor(alpha).to(dtype)[None, None, :]
    b = torch.as_tensor(beta).to(dtype)[None, None, :]
    lg = torch.lgamma
    lp = (lg(n + 1) - lg(y + 1) - lg(n - y + 1)
          + lg(y + a) + lg(n - y + b) - lg(n + a + b)
          - (lg(a) + lg(b) - lg(a + b)))
    return lp.sum(dim=1)


def hazard_table(kappa, omega, u, d_max, dtype=torch.float64, tail=1e-22):
    """(R, d_max) hazard rho[r, d - 1] = h(d - u) / S(d - u - 1) of a
    negative binomial sojourn NB(kappa, omega) shifted by the minimum
    duration u: h the pmf C(k + kappa - 1, k) omega^k (1 - omega)^kappa,
    S(k - 1) = sum_{j >= k} h(j), summed from the far tail in log space.
    0 below u; the guard 0.1 where S underflows float32."""
    kappa = torch.as_tensor(kappa, dtype=torch.float64)[:, None]
    omega = torch.as_tensor(omega, dtype=torch.float64)[:, None]
    k_hi = d_max + int(math.ceil(math.log(tail) / math.log(float(omega.max())))) + 64
    k = torch.arange(k_hi, dtype=torch.float64)[None, :]
    log_h = (torch.lgamma(k + kappa) - torch.lgamma(kappa) - torch.lgamma(k + 1)
             + kappa * torch.log1p(-omega) + k * torch.log(omega))
    log_s = torch.flip(torch.logcumsumexp(torch.flip(log_h, [1]), dim=1), [1])  # log P(K >= k)
    d = torch.arange(1, d_max + 1)
    kk = (d - u).clamp(min=0)
    lh = log_h[:, kk]
    ls = torch.where(d > u, log_s[:, kk], 0.0)
    rho = torch.where(d >= u, torch.exp(lh - ls), 0.0)
    # float32's S: I_omega(k, kappa) by the continued fraction times its
    # prefactor omega^k (1 - omega)^kappa / (k B(k, kappa)), on the side
    # where the fraction converges (omega < (k + 1) / (k + kappa + 2)); the
    # other side is 1 - I_{1 - omega}(kappa, k), which does not underflow.
    kf = kk.to(torch.float64).clamp(min=1.0)[None, :]
    log_pre = (kf * torch.log(omega) + kappa * torch.log1p(-omega)
               - (torch.lgamma(kf) + torch.lgamma(kappa) - torch.lgamma(kf + kappa)) - torch.log(kf))
    lost = (omega < (kf + 1) / (kf + kappa + 2)) & (torch.minimum(log_pre, ls) < math.log(FLT_MIN))
    rho = torch.where((d > u) & lost, GUARD, rho)
    return rho.to(dtype)


class Model:
    """The model's tables for one segment, in one dtype: emission tables
    (T, R) of control and case, hazard tables (R, d_max), the control
    transition matrix log P (R, R) with a -inf diagonal and the merged
    chain's (2, 2) log probabilities."""

    def __init__(self, *, mu, sigma, log_p, omega_control, omega_case, kappa, merge_log_prob,
                 split_prob, min_duration, d_max, counts, dtype=torch.float64, device="cpu"):
        f64 = lambda x: torch.as_tensor(x, dtype=torch.float64)
        R = len(mu)
        self.R, self.u, self.dtype, self.device = R, int(min_duration), dtype, torch.device(device)
        a, b = alpha_beta(f64(mu), f64(sigma))
        to = lambda x: x.to(dtype).to(self.device)
        y_c, n_c, y_k, n_k = counts
        self.E_c = to(emission_table(y_c, n_c, a, b, dtype))
        self.E_k = to(emission_table(y_k, n_k, a, b, dtype))
        kap = f64(kappa) * torch.ones(R, dtype=torch.float64)
        self.rho_c = to(hazard_table(kap, f64(omega_control), self.u, d_max, dtype))
        self.rho_k = to(hazard_table(kap, f64(omega_case) * torch.ones(R, dtype=torch.float64),
                                     self.u, d_max, dtype))
        self.log_p = to(f64(log_p))
        pm = math.exp(float(merge_log_prob))
        self.log_p_merged = to(torch.log(f64([[1.0 - pm, pm], [split_prob, 1.0 - split_prob]])))


def _rho(table, d, r):
    return table[r.clamp(0, table.shape[0] - 1), (d - 1).clamp(0, table.shape[1] - 1)]


def transition_log_prob(model, prev, nxt, step0=False):
    """log f(nxt | prev) over broadcastable (..., 5) int64 states; step0
    scores the first site against the phantom state (merged chain forced
    to merged, both hazards 1)."""
    R, dt = model.R, model.dtype
    zero = torch.zeros((), dtype=dt, device=model.device)
    neg = torch.full((), _NEG, dtype=dt, device=model.device)
    ind = lambda c: torch.where(c, zero, neg)
    m_p, dc_p, rc_p, dk_p, rk_p = prev.unbind(-1)
    m_n, dc_n, rc_n, dk_n, rk_n = nxt.unbind(-1)

    lpm = model.log_p_merged
    if step0:
        lp_m = ind(m_n == 1)
        rho_c = torch.ones((), dtype=dt, device=model.device)
        rho_k = rho_c
    else:
        gate = torch.minimum(dk_p, dc_p) >= model.u
        lp_m = torch.where(gate, lpm[m_p.clamp(0, 1), m_n.clamp(0, 1)], ind(m_n == m_p))
        rho_c = _rho(model.rho_c, dc_p, rc_p)
        rho_k = _rho(model.rho_k, dk_p, rk_p)

    live = (rc_p >= 0) & (rc_n >= 0)
    lp_p = torch.where(live, model.log_p[rc_p.clamp(0, R - 1), rc_n.clamp(0, R - 1)], neg)
    lp_c = torch.where(dc_n == 1, torch.log(rho_c) + lp_p,
                       torch.log1p(-rho_c) + ind(dc_p == dc_n - 1) + ind(rc_p == rc_n))

    lp_a = ind((rk_n == rc_n) & (dk_n == dc_n))
    lp_b = ind(rk_n != rc_n) - math.log(R - 1.0) + ind(dk_n == 1)
    log_opts = torch.where(rc_n != rk_p, math.log(R - 2.0), math.log(R - 1.0)).to(dt)
    lp_unif2 = ind((rk_n != rc_n) & (rk_n != rk_p)) - log_opts
    lp_cbr = ind(dk_n == 1) + lp_unif2
    lp_d = torch.where(dk_n == 1, torch.log(rho_k) + lp_unif2,
                       torch.log1p(-rho_k) + ind(dk_p + 1 == dk_n) + ind(rk_p == rk_n))
    in_a = m_n == 1
    in_b = (m_p == 1) & (dc_n != 1)
    in_c = (rc_n == rk_p) & (m_p == 0)
    lp_k = torch.where(in_a, lp_a, torch.where(in_b, lp_b, torch.where(in_c, lp_cbr, lp_d)))
    return torch.where(live, lp_m + lp_c + lp_k, neg)


def expand(anc, R):
    """The I children of each ancestor: (M, 5) -> (I, M, 5), the slot
    layout of the module docstring."""
    M = anc.shape[0]
    m, dc, rc, dk, rk = anc.unbind(-1)
    one = torch.ones_like(m)
    rows = [torch.stack([m, dc + 1, rc, dk + 1, rk], -1)]
    skip_k = torch.where((rk >= 0) & (rk < R), rk, 0)
    skip_c = torch.where((rc >= 0) & (rc < R), rc, 0)
    for j in range(R - 1):  # control change points, regimes ascending minus r_k
        reg = torch.where(j < skip_k, j, j + 1)
        rows.append(torch.stack([0 * m, one, reg, dk + 1, rk], -1))
    for j in range(R - 1):  # case change points, regimes ascending minus r_c
        reg = torch.where(j < skip_c, j, j + 1)
        rows.append(torch.stack([0 * m, dc + 1, rc, one, reg], -1))
    md = torch.where(m == 0, dc + 1, 0)
    rows.append(torch.stack([one, md, rc, md, rc], -1))
    pairs = torch.tensor([[int(i == j), 1, i, 1, j] for i in range(R) for j in range(R)],
                         dtype=anc.dtype, device=anc.device)
    return torch.cat([torch.stack(rows, 0), pairs[:, None, :].expand(R * R, M, 5)], 0)


def observation(model, t, states):
    """Emission log-likelihood of site t at each state's regimes."""
    R = model.R
    return model.E_c[t, states[..., 2].clamp(0, R - 1)] + model.E_k[t, states[..., 4].clamp(0, R - 1)]


def optimal_log_c(lw, M):
    """log c of Fearnhead's optimal resampling of normalised log weights
    lw (N,): sum_i min(1, c w_i) = M; None where no c is consistent."""
    w = torch.sort(torch.exp(lw), descending=True).values
    suffix = torch.flip(torch.cumsum(torch.flip(w, [0]), 0), [0])
    k = torch.arange(M + 1, dtype=lw.dtype, device=lw.device)
    log_c = torch.log(M - k) - torch.log(suffix[: M + 1])
    prev = torch.cat([torch.full((1,), math.inf, dtype=lw.dtype, device=lw.device),
                      torch.log(w[:M])])
    ok = (log_c + torch.log(w[: M + 1]) <= 0) & (log_c + prev >= 0) & (k < M)
    if not bool(ok.any()):
        return None
    return float(log_c[int(torch.nonzero(ok)[0, 0])])


def _tv(lw_a, lw_b):
    """Total variation between two normalised log-weight vectors."""
    return 0.5 * float((torch.exp(lw_a) - torch.exp(lw_b)).abs().sum())


def step_weights(model, t, lw_prev, parts_prev, parts_t, lw_t, shift_t, M):
    """The reference's unnormalised log weights (N,) of site t >= 1, given
    the program's normalised weights and particles at t - 1 and the
    children it kept at t, and the count of children whose state is not
    their ancestor's expansion (with live blocks no particle at t - 1
    could have parented). Each ancestor's weight factor is
    max(w_a, 1/c) under optimal resampling (w_a where nothing is
    resampled, 1/M in the fallback); where states tie, the candidate that
    fits the program's weights is taken."""
    R, dt = model.R, model.dtype
    I = 2 * R + R * R
    lw_prev = lw_prev.to(dt)
    finite = torch.isfinite(lw_prev)
    children = parts_t.reshape(I, M, 5)
    anc = children[0].clone()
    anc[:, 1] -= 1
    anc[:, 3] -= 1
    prog = (lw_t.to(torch.float64) + float(shift_t)).reshape(I, M)
    live = torch.isfinite(prog).any(0)
    bad = int(((expand(anc, R) != children).any(-1) & live[None]).sum())

    gamma = transition_log_prob(model, anc[None].expand(I, M, 5), children) + observation(model, t, children)
    if int(finite.sum()) > M:
        log_c = optimal_log_c(lw_prev.to(torch.float64), M)
        factor = (torch.full_like(lw_prev, -math.log(M)) if log_c is None
                  else torch.maximum(lw_prev, torch.full_like(lw_prev, -log_c)))
    else:
        factor = lw_prev
    cand = (state_keys(parts_prev)[None, :] == state_keys(anc)[:, None]) & finite[None]  # (M, N)
    both = torch.isfinite(prog) & torch.isfinite(gamma.to(torch.float64))
    est = torch.where(both, prog - gamma.to(torch.float64), torch.nan).nanmedian(0).values  # (M,)
    gap = torch.where(cand, (factor.to(torch.float64)[None] - est[:, None]).abs(), math.inf)
    gap = torch.where(torch.isnan(gap), math.inf, gap)
    pick = gap.argmin(1)
    has = cand.any(1)
    bad += int((live & ~has).sum())
    v = torch.where(has, factor[pick], torch.full_like(factor[pick], _NEG))
    return (v[None, :] + gamma).reshape(-1), bad


def first_weights(model, parts0, lw0, init_shift):
    """The reference's unnormalised log weights (N,) of site 0: the R**2
    state-independent proposals scored against the phantom merged state
    of regime r, for the r that fits the program's weights (the program
    draws r at random); -inf on the padding slots."""
    R, dt = model.R, model.dtype
    n0 = R * R
    prog = lw0.to(torch.float64) + float(init_shift)
    best, best_gap = None, math.inf
    for r in range(R):
        phantom = torch.tensor([1, 0, r, 0, r], device=parts0.device)
        w = (transition_log_prob(model, phantom, parts0[:n0], step0=True)
             + observation(model, 0, parts0[:n0]))
        full = torch.full((parts0.shape[0],), _NEG, dtype=dt, device=parts0.device)
        full[:n0] = w
        f64 = full.to(torch.float64)
        both = torch.isfinite(f64) & torch.isfinite(prog)
        same = bool((torch.isfinite(f64) == torch.isfinite(prog)).all()) and bool(both.any())
        gap = float((f64 - prog)[both].abs().max()) if same else math.inf
        if gap < best_gap:
            best, best_gap = full, gap
    indep = parts0.new_tensor([[int(i == j), 1, i, 1, j] for i in range(R) for j in range(R)])
    return best, int((parts0[:n0] != indep).any(-1).sum())


def normalise(raw, dtype=torch.float64):
    """(log weights less their logsumexp, the logsumexp), in ``dtype``."""
    raw = raw.to(dtype)
    shift = torch.logsumexp(raw, 0)
    return raw - shift, float(shift)


def judge_site(raw_ref, lw_t, shift_t):
    """(total variation, |shift gap|) between the program's normalised
    weights and shift at a site and the reference's unnormalised weights."""
    lw_ref, shift_ref = normalise(raw_ref)
    return _tv(lw_t.to(torch.float64), lw_ref), abs(float(shift_t) - shift_ref)


def state_keys(states):
    """One int64 a (..., 5) state, equal exactly where the states are:
    the fields offset to be non-negative and packed (m and the regimes in
    4 bits, the durations in 21)."""
    m, dc, rc, dk, rk = (states.to(torch.int64) + 2).unbind(-1)
    return ((((m << 21 | dc) << 4 | rc) << 21 | dk) << 4) | rk


def _groups(*states):
    """Group ids of the rows of each (n_i, 5) state tensor, shared across
    them (equal states, equal ids), and the number of groups."""
    keys = torch.cat([state_keys(x) for x in states])
    _, inv = torch.unique(keys, return_inverse=True)
    return torch.split(inv, [x.shape[0] for x in states]), int(inv.max()) + 1 if inv.numel() else 0


def resampling_faults(lw_prev, parts_prev, parts_t, lw_t, M, R, margin=1e-3):
    """(survivor gap, heavy dropped) of the resampling between t - 1 and t,
    read off the program's state; both are 0 for optimal resampling.

    Survivors are the ancestor blocks at t with a live child; they number
    M where more than M particles lived at t - 1, else as many as lived.
    Optimal resampling keeps, deterministically, every particle whose
    c w is at least 1 (c from ``optimal_log_c``); a particle with
    log(c w) >= ``margin`` that no ancestor block's state accounts for is
    dropped. States repeat across blocks, so the count is by state: a
    state's heavy particles at t - 1 beyond its ancestor blocks at t."""
    I = 2 * R + R * R
    lw_prev = lw_prev.to(torch.float64)
    finite = torch.isfinite(lw_prev)
    n_fin = int(finite.sum())
    children = parts_t.reshape(I, M, 5)
    anc = children[0].clone()
    anc[:, 1] -= 1
    anc[:, 3] -= 1
    live = torch.isfinite(lw_t.reshape(I, M)).any(0)
    if n_fin > M:
        log_c = optimal_log_c(lw_prev, M)
        heavy = finite & (lw_prev + log_c >= margin) if log_c is not None else torch.zeros_like(finite)
    else:
        heavy = finite
    gap = abs(int(live.sum()) - min(M, n_fin))
    if not bool(heavy.any()):
        return gap, 0
    (want, have), size = _groups(parts_prev[heavy], anc[live])
    need = torch.bincount(want, minlength=size)
    kept = torch.bincount(have, minlength=size)
    return gap, int((need - kept).clamp(min=0).sum())


def systematic_mismatch(lw_prev, parts_prev, parts_t, lw_t, M, R, tol=1e-5):
    """Ancestors at t that no systematic draw explains: the least, over
    every systematic uniform u, of the resampled ancestors whose states a
    draw with u does not give (0 for optimal resampling).

    Optimal resampling keeps each particle with c w > 1 and draws the
    other L = M - K ancestors systematically in index order from the
    residual weights: the grid (j + u) s, j < L, s their total over L, on
    their cumulative sum Pi, picks for each grid point the first index
    with Pi >= it. Which set of indices a draw picks changes only where a
    grid point crosses some Pi_i, so one u inside each piece between
    those crossings covers every draw, a grid point that float32 rounds
    across a crossing included. A particle with |log(c w)| < ``tol`` may
    be kept or drawn in float32: both are tried. States repeat across
    particles, so the sets are compared as multisets of states. 0 where
    no resampling happened (M or fewer particles lived) or where the
    resampler fell back to multinomial draws."""
    I = 2 * R + R * R
    lw_prev = lw_prev.to(torch.float64)
    finite = torch.isfinite(lw_prev)
    if int(finite.sum()) <= M:
        return 0
    log_c = optimal_log_c(lw_prev, M)
    if log_c is None:
        return 0
    children = parts_t.reshape(I, M, 5)
    anc = children[0].clone()
    anc[:, 1] -= 1
    anc[:, 3] -= 1
    live = torch.isfinite(lw_t.reshape(I, M)).any(0)
    (gid, anc_gid), size = _groups(parts_prev, anc[live])
    blocks = torch.bincount(anc_gid, minlength=size)
    best = None
    for edge in {tol, -tol} if bool(((lw_prev + log_c).abs() < tol).any()) else {0.0}:
        kept = finite & (lw_prev + log_c > edge)
        L = M - int(kept.sum())
        # The resampled ancestors: the live blocks less the kept particles, by state.
        chosen = (blocks - torch.bincount(gid[kept], minlength=size)).clamp(min=0)
        if L <= 0:
            miss = int(chosen.sum())
        else:
            miss = max(L, int(chosen.sum())) - _most_in_common(
                torch.where(kept | ~finite, 0.0, torch.exp(lw_prev + log_c)), L, gid, chosen)
        best = miss if best is None else min(best, miss)
    return best


def _most_in_common(pi, L, gid, chosen):
    """The most states, over all systematic draws of L from the inclusion
    weights ``pi``, that a draw shares with the multiset ``chosen`` (a
    count a state group ``gid``)."""
    cum = torch.cumsum(pi, 0)
    step = float(cum[-1]) / L
    cross = torch.unique(torch.remainder(cum / step, 1.0))
    edges = torch.cat([torch.zeros(1, dtype=torch.float64), cross, torch.ones(1, dtype=torch.float64)])
    u = 0.5 * (edges[1:] + edges[:-1])
    u = u[edges[1:] > edges[:-1]]
    grid = (torch.arange(L, dtype=torch.float64)[None, :] + u[:, None]) * step  # (P, L)
    drawn = torch.searchsorted(cum, grid.reshape(-1)).clamp(max=cum.numel() - 1).reshape(grid.shape)
    # Per draw, the states it gives in order; the k-th copy of a state is
    # in common where the resampled ancestors hold more than k of it.
    g = torch.sort(gid[drawn], 1).values
    pos = torch.arange(L).expand_as(g)
    start = torch.where(torch.cat([torch.ones_like(g[:, :1], dtype=torch.bool), g[:, 1:] != g[:, :-1]], 1),
                        pos, 0).cummax(1).values
    return int(((pos - start) < chosen[g]).sum(-1).max())


def backward_logits(model, lw_t, parts_t, nxt):
    """(B, N) logits of the backward kernel at site t: lw_t[n] + log
    f(nxt[b] | parts_t[n]), in the model's dtype."""
    return lw_t.to(model.dtype)[None, :] + transition_log_prob(model, parts_t[None, :, :], nxt[:, None, :])


def backward_pit(model, lw_t, parts_t, nxt, chosen, v, top=0.99):
    """Randomised probability integral transform of B backward draws at
    site t: (u, impossible). Under the reference's kernel
    p(n | b) ~ w_t[n] f(nxt[b] | x_t[n]), the live particles' distinct
    states s, each of weight W_s (the sum of its particles'), are ordered
    by their first index; a draw of state s gives
    u = P(states before s) + v P(s), v uniform on [0, 1). For draws from
    that kernel u is uniform on [0, 1) and independent across draws,
    whatever the kernel. Most kernels are all but certain (away from a
    change point at t + 1 the state at t follows from it), and their u is
    v whatever was drawn, so u is kept only for kernels whose likeliest
    state holds at most ``top`` of the mass: a choice made from the
    kernel alone, before the draw, which keeps u uniform. ``impossible``
    counts draws whose state the kernel gives probability 0."""
    live = torch.isfinite(lw_t)
    N = parts_t.shape[0]
    parts, lw = parts_t[live], lw_t[live].to(torch.float64)
    keys, inv = torch.unique(state_keys(parts), return_inverse=True)
    G = keys.numel()
    top_lw = torch.full((G,), _NEG, dtype=torch.float64).scatter_reduce(0, inv, lw, "amax")
    log_w = top_lw + torch.log(torch.zeros(G, dtype=torch.float64).index_add_(0, inv, torch.exp(lw - top_lw[inv])))
    first = torch.full((G,), N, dtype=torch.int64).scatter_reduce(0, inv, torch.arange(N)[live], "amin")
    rep = torch.empty((G, 5), dtype=parts.dtype)
    rep[inv] = parts
    logits = log_w.to(model.dtype)[None, :] + transition_log_prob(model, rep[None, :, :], nxt[:, None, :])
    logits = logits.to(torch.float64)
    ok = torch.isfinite(logits).any(-1)
    p = torch.softmax(torch.where(ok[:, None], logits, 0.0), -1)  # (B, G)
    match = keys[None, :] == state_keys(chosen)[:, None]  # (B, G)
    g = first[match.to(torch.int8).argmax(-1)]
    mass = (p * match).sum(-1)
    below = (p * (first[None, :] < g[:, None])).sum(-1)
    good = ok & match.any(-1) & (mass > 0)
    u = below + torch.as_tensor(v, dtype=torch.float64) * mass
    return u[good & (p.max(-1).values <= top)], int((~good).sum())


def backward_draw(model, lw_t, parts_t, nxt, generator):
    """(B, 5) states drawn from the backward kernel computed in the
    model's dtype, by Gumbel-max (the control's draws)."""
    logits = backward_logits(model, lw_t, parts_t, nxt).to(torch.float32)
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float64).clamp(min=1e-300)
    return parts_t[torch.argmax(logits.to(torch.float64) - torch.log(-torch.log(u)), -1)]


def ks_sqrt_n(u):
    """sqrt(n) times the Kolmogorov-Smirnov distance of the sample u to the
    uniform law on [0, 1): the Kolmogorov statistic, whose law does not
    depend on n (P > 1.95 is 0.1%, P > 2.5 under 1e-5); 0 for no sample."""
    u = torch.sort(torch.as_tensor(u, dtype=torch.float64).reshape(-1)).values
    n = u.numel()
    if n == 0:
        return 0.0
    i = torch.arange(1, n + 1, dtype=torch.float64)
    d = torch.maximum((i / n - u).max(), (u - (i - 1) / n).max())
    return math.sqrt(n) * float(d)


def impossible_transitions(model, traj):
    """Transitions of (T, B, 5) trajectories that the model gives zero
    probability: a count, 0 for paths the model can take."""
    lp = transition_log_prob(model, traj[:-1], traj[1:])
    return int((~torch.isfinite(lp)).sum())


def functionals(traj, R, dtype=torch.float64):
    """Split probability (T,) and regime marginals (T, 2R) of (T, B, 5)
    trajectories: the share of the B paths split, and in each regime."""
    mean = lambda x: x.to(dtype).mean(-1)
    split = mean(traj[..., 0] == 0)
    ctrl = [mean(traj[..., 2] == r) for r in range(R)]
    case = [mean(traj[..., 4] == r) for r in range(R)]
    return split, torch.stack(ctrl + case, -1)
