"""Resampling schemes for the particle filter: the plain PyTorch versions.

Counterpart of hygeia_tpu/ops/resampling.py, batched over a leading unit
axis U: ``log_weights`` is (U, N), every result carries U in front.

Randomness is injected, not drawn: ``u_sys`` (U,) is the systematic uniform
and ``u_mult`` (U, M) the multinomial uniforms, the draws that the JAX
package makes from ``jax.random.split(key)`` (resampling.py:260-263, :139).
A test can therefore hand both packages the same numbers.

``optimal_finite_state_resampling`` here is the plain version of the CUDA
kernel in ops/cuda_resampling.py; the filter calls that module's
``optimal_resampling``, which takes this function for CPU tensors.

Top-k order: ``lax.top_k`` puts the lowest index first among equal values.
``torch.topk`` promises no order, so ``_top_k`` uses a stable descending
sort, which keeps equal values in index order.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_NEG_INF = float("-inf")


class ResampleResult(NamedTuple):
    parent_indices: torch.Tensor  # (U, M) int32
    log_c: torch.Tensor  # (U,) f32; 0.0 for unbiased schemes
    use_unbiased: torch.Tensor  # (U,) bool; True -> weights Z/M
    new_log_weights: torch.Tensor  # (U, M) post-resampling log weights
    top_m_indices: torch.Tensor  # (U, M) int32, descending weight order


def _top_k(x, k):
    """(values, indices) of the k largest entries along the last axis,
    descending, lowest index first among ties (lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _normalise(log_weights):
    log_z = torch.logsumexp(log_weights, dim=-1, keepdim=True)
    return log_weights - log_z, log_z[..., 0]


def _count_below(q, t, *, strict=True):
    """#{i: q_i < t} (strict) or #{i: q_i <= t} for each t of a row: q (U, N),
    t (U, K) -> (U, K). The comparison count that the JAX code and the CUDA
    kernel take, computed as a binary search over q sorted: exact whether
    or not a parallel prefix sum rounded q to a non-decreasing sequence,
    and O((N + K) log N) instead of O(K N)."""
    return torch.searchsorted(torch.sort(q, dim=-1).values, t, right=not strict)


def systematic_resampling(log_norm_weights, num_offspring, u_sys):
    """M offspring by systematic resampling: grid (j + u)/M scaled by the
    realised total of the weight CDF, first index i with T_j <= Q_i."""
    m = num_offspring
    n = log_norm_weights.shape[-1]
    q = torch.cumsum(torch.exp(log_norm_weights), dim=-1)
    grid = torch.arange(m, dtype=torch.float32, device=q.device)
    # Scaled by the realised total mass: an unscaled grid point past a
    # rounded-down total would select a zero-weight (dead) slot.
    t = (grid[None, :] + u_sys[:, None]) / m * q[:, -1:]
    idx = _count_below(q, t)
    return torch.clamp(idx, 0, n - 1).to(torch.int32)


def multinomial_resampling(log_weights, num_offspring, u_mult, *, normalized=False):
    """M iid categorical draws by inverse CDF with injected uniforms (U, M).

    ``<=`` (first q strictly above t): zero-weight slots have q_i == q_{i-1}
    and are never hit, even at exact CDF boundaries."""
    n = log_weights.shape[-1]
    log_norm = log_weights if normalized else _normalise(log_weights)[0]
    q = torch.cumsum(torch.exp(log_norm), dim=-1)
    idx = _count_below(q, u_mult[:, :num_offspring] * q[:, -1:], strict=False)
    return torch.clamp(idx, 0, n - 1).to(torch.int32)


def unbiased_resampling(
    log_weights, num_offspring, u_sys, u_mult, multinomial=False, *, normalized=False
):
    """Systematic or multinomial resampling; every offspring weighs Z/M."""
    U = log_weights.shape[0]
    if normalized:
        log_norm = log_weights
        log_z = torch.zeros((U,), dtype=log_weights.dtype, device=log_weights.device)
    else:
        log_norm, log_z = _normalise(log_weights)
    if multinomial:
        parents = multinomial_resampling(log_norm, num_offspring, u_mult, normalized=True)
    else:
        parents = systematic_resampling(log_norm, num_offspring, u_sys)
    new_w = (log_z - math.log(num_offspring))[:, None].expand(U, num_offspring)
    _, top_idx = _top_k(log_weights, num_offspring)
    return ResampleResult(
        parent_indices=parents,
        log_c=torch.zeros_like(log_z),
        use_unbiased=torch.ones((U,), dtype=torch.bool, device=log_weights.device),
        new_log_weights=new_w.to(log_weights.dtype),
        top_m_indices=top_idx.to(torch.int32),
    )


def keep_top_m(log_weights, num_offspring):
    """The M largest weights kept as they are (no resampling)."""
    vals, parents = _top_k(log_weights, num_offspring)
    U = log_weights.shape[0]
    return ResampleResult(
        parent_indices=parents.to(torch.int32),
        log_c=torch.zeros((U,), dtype=log_weights.dtype, device=log_weights.device),
        use_unbiased=torch.zeros((U,), dtype=torch.bool, device=log_weights.device),
        new_log_weights=vals,
        top_m_indices=parents.to(torch.int32),
    )


def optimal_finite_state_resampling(log_weights, num_offspring, u_sys, u_mult):
    """Fearnhead's optimal finite-state resampling under the normalized=True
    contract (logsumexp of each row is 0), batched over U.

    Finds c with sum_i min(1, c W_i) = M, keeps the K particles with
    c W_i > 1 and resamples the other M - K systematically from the
    residual weights. Post-resampling log weights: kept -> previous weight,
    resampled -> -log c. When no threshold is consistent (e.g. fewer than M
    live weights), falls back to multinomial resampling with weights 1/M
    and log_c = 0. Mirrors hygeia_tpu/ops/resampling.py:173-289.
    """
    U, n = log_weights.shape
    m = num_offspring
    dtype = log_weights.dtype
    dev = log_weights.device
    kk = min(m + 1, n)

    top_lw, top_idx = _top_k(log_weights, kk)
    top_q = torch.exp(top_lw)
    # Q_k, the suffix mass from rank k on, as a sum of POSITIVE terms: the
    # reversed cumsum over the top block plus the directly summed tail. The
    # 1 - prefix form cancels catastrophically in f32 once the top particles
    # hold nearly all the mass, and then no candidate k passes.
    expw = torch.exp(log_weights)
    top_mask = torch.zeros((U, n), dtype=torch.bool, device=dev).scatter_(1, top_idx, True)
    tail = torch.where(top_mask, 0.0, expw).sum(dim=-1, keepdim=True)
    suffix = torch.flip(torch.cumsum(torch.flip(top_q, [-1]), dim=-1), [-1]) + tail

    k_range = torch.arange(kk, dtype=dtype, device=dev)
    log_c_k = torch.log(torch.clamp(m - k_range, min=0.0)) - torch.log(suffix)
    # k is consistent iff c_k q_k <= 1 and (k == 0 or c_k q_{k-1} >= 1), k <= m.
    # The previous-particle check is INCLUSIVE: at an exact boundary tie
    # (f32 produces them) a strict check rejects every k and triggers the
    # multinomial fallback spuriously.
    below = log_c_k + top_lw <= 0.0
    prev_lw = torch.cat(
        [torch.full((U, 1), float("inf"), dtype=dtype, device=dev), top_lw[:, :-1]], dim=1
    )
    above_prev = log_c_k + prev_lw >= 0.0
    ok = below & above_prev & (k_range <= m)
    any_ok = ok.any(dim=-1)
    k_int = torch.arange(kk, device=dev)
    k_star = torch.where(ok, k_int, kk).min(dim=-1).values  # first consistent k
    k_star = torch.where(any_ok, k_star, n)
    log_c = torch.where(
        any_ok,
        log_c_k.gather(1, torch.clamp(k_star, 0, kk - 1)[:, None])[:, 0],
        _NEG_INF,
    )

    slots = torch.arange(m, device=dev)
    kept_parents = top_idx[:, torch.clamp(slots, 0, kk - 1)]
    kept = slots[None, :] < k_star[:, None]  # (U, M)

    # Residual systematic resampling over the unsorted weights with the kept
    # set masked out; the grid is scaled by the realised residual total.
    kept_mask = torch.zeros((U, n), dtype=torch.bool, device=dev).scatter_(
        1, top_idx, k_int[None, :] < k_star[:, None]
    )
    resid_w = torch.where(kept_mask, 0.0, expw)
    q_resid = torch.cumsum(resid_w, dim=-1)
    l = torch.clamp(m - k_star, min=1).to(torch.float32)
    grid = torch.arange(m, dtype=torch.float32, device=dev)
    t = (grid[None, :] + u_sys[:, None]) / l[:, None] * q_resid[:, -1:]
    sys_idx = torch.clamp(slots[None, :] - k_star[:, None], 0, m - 1)
    resampled = torch.clamp(_count_below(q_resid, t.gather(1, sys_idx)), 0, n - 1)
    parents = torch.where(kept, kept_parents, resampled)

    new_w = torch.where(kept, log_weights.gather(1, parents), -log_c[:, None])

    # Fallback when log_c is non-finite: multinomial, unbiased weights.
    bad = ~torch.isfinite(log_c)
    mult = multinomial_resampling(log_weights, m, u_mult, normalized=True)
    parents = torch.where(bad[:, None], mult, parents).to(torch.int32)
    new_w = torch.where(bad[:, None], -math.log(m), new_w)
    log_c = torch.where(bad, 0.0, log_c)
    return ResampleResult(
        parent_indices=parents,
        log_c=log_c,
        use_unbiased=bad,
        new_log_weights=new_w.to(dtype),
        top_m_indices=kept_parents.to(torch.int32),
    )
