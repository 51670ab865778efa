"""Change-point hazard tables for the two-group model.

Counterpart of hygeia_tpu/ops/hazard.py (``rho_two_group``, ``gather_rho``).

The survival function needs the regularised incomplete beta, which PyTorch
lacks. ``betainc`` below ports JAX's own implementation (the Lentz continued
fraction of jax/_src/lax/special.py, itself a port of XLA's math.cc) and
evaluates it in the table's dtype. That is load-bearing: in float32 the
survival function underflows in the deep tail and the reference's 0.1 guard
takes over from a sojourn that depends on the f32 evaluation itself, so a
table computed in f64 and cast would switch to the guard later than the JAX
package's f32 table does.
"""

from __future__ import annotations

import torch

from hygeia_tpu_torch.ops.distributions import neg_binomial_log_pmf

_NEG_INF = float("-inf")
# Matches fixed_value_inf of the reference two-group model.
_FIXED_VALUE_INF = 0.1


def _lentz(a, b, x, *, num_iterations, small):
    """Lentz-Thompson-Barnett evaluation of the incomplete-beta continued
    fraction (DLMF 8.17.22). Like XLA's loop, every element keeps iterating
    until ALL elements have converged, so the result does not depend on
    where each element alone would have stopped."""
    one = torch.ones_like(a)
    two = torch.full_like(a, 2.0)
    h = torch.full_like(x, small)  # partial denominator 0 is below `small`
    c = h
    d = torch.zeros_like(h)
    it = 1
    unconverged = True
    while it < num_iterations and unconverged:
        if it == 1:
            num = torch.ones_like(x)
        else:
            m = (it - 1) // 2
            if it % 2 == 0:
                if m == 0:
                    num = -(a + b) * x / (a + one)
                else:
                    num = -(a + m) * (a + b + m) * x / (
                        (a + two * m) * (a + two * m + one)
                    )
            else:
                num = m * (b - m) * x / ((a + two * m - one) * (a + two * m))
        c = 1.0 + num / c
        c = torch.where(c.abs() < small, small, c)
        d = 1.0 + num * d
        d = torch.where(d.abs() < small, small, d)
        d = torch.reciprocal(d)
        delta = c * d
        h = h * delta
        it += 1
        # One host read per iteration; the table is built once per segment.
        unconverged = bool(((delta - 1.0).abs() >= small).any())
    return h


def _flush_subnormal(v):
    """Flush subnormal values to zero. XLA's CPU and TPU backends run with
    flush-to-zero, so the JAX table's survival function reaches 0, and the
    0.1 guard fires, as soon as it drops below the dtype's smallest normal
    number; PyTorch keeps subnormals, which would move the guard onset
    ~75 sojourns later in f32."""
    return torch.where(v.abs() < torch.finfo(v.dtype).tiny, 0.0, v)


def betainc(a, b, x):
    """Regularised incomplete beta I_x(a, b), elementwise, in x's dtype."""
    a, b, x = torch.broadcast_tensors(a, b, x)
    dtype = x.dtype
    finfo = torch.finfo(dtype)
    small = finfo.eps / 2
    inf = float("inf")

    a_is_zero = (a == 0) | (b == inf)
    b_is_zero = (b == 0) | (a == inf)
    x_is_zero = x == 0
    x_is_one = x == 1
    is_nan = torch.isnan(a) | torch.isnan(b) | torch.isnan(x)
    result_is_zero = (b_is_zero & ~x_is_one) | (a_is_zero & x_is_zero)
    result_is_one = (a_is_zero & ~x_is_zero) | (b_is_zero & x_is_one)
    result_is_nan = (a < 0) | (b < 0) | (x < 0) | (x > 1)
    result_is_nan = result_is_nan | (a_is_zero & b_is_zero) | is_nan

    # The fraction converges fast for x < (a+1)/(a+b+2); otherwise use the
    # symmetry I_x(a, b) = 1 - I_{1-x}(b, a) (DLMF 8.17.4).
    fast = x < (a + 1.0) / (a + b + 2.0)
    a, b = torch.where(fast, a, b), torch.where(fast, b, a)
    x = torch.where(fast, x, 1.0 - x)

    cf = _lentz(
        a, b, x,
        num_iterations=200 if dtype == torch.float32 else 600,
        small=small,
    )
    very_small = finfo.tiny * 2
    lbeta_small_a = torch.lgamma(b) - torch.lgamma(a + b)
    lbeta = torch.lgamma(a) + lbeta_small_a
    factor = torch.where(
        a < very_small,
        torch.exp(torch.log1p(-x) * b - lbeta_small_a),
        torch.exp(torch.log(x) * a + torch.log1p(-x) * b - lbeta) / a,
    )
    result = _flush_subnormal(cf * _flush_subnormal(factor))
    result = torch.where(fast, result, 1.0 - result)
    result = torch.where(result_is_zero, 0.0, result)
    result = torch.where(result_is_one, 1.0, result)
    return torch.where(result_is_nan, float("nan"), result)


def rho_two_group(kappa, omega, u, d_max):
    """Two-group hazard table rho[r, d-1] = h(d-u) / S(d-u-1), (R, d_max).

    h is the NB(kappa, omega) pmf and S its survival function,
    S(k-1) = I_omega(k, kappa). The reference's guards are kept:
      * rho = 0 where d < u (log h = -inf),
      * any non-finite rho replaced by 0.1 (the deep tail, where S
        underflows in the table's dtype).
    """
    dtype = torch.promote_types(torch.promote_types(kappa.dtype, omega.dtype), torch.float32)
    d = torch.arange(1, d_max + 1, dtype=dtype, device=kappa.device)[None, :]
    kappa_c = kappa.to(dtype)[:, None]
    omega_c = omega.to(dtype)[:, None]

    shifted = torch.clamp(d - u, min=0.0)
    log_h = torch.where(
        d >= u, neg_binomial_log_pmf(shifted, kappa_c, omega_c), _NEG_INF
    )
    surv_prev = betainc(torch.clamp(shifted, min=1.0), kappa_c, omega_c)
    log_surv_prev = torch.where(d > u, torch.log(surv_prev), 0.0)
    rho = torch.where(log_h == _NEG_INF, 0.0, torch.exp(log_h - log_surv_prev))
    return torch.where(torch.isfinite(rho), rho, _FIXED_VALUE_INF)


def gather_rho(rho_table, d_prev, r_prev):
    """rho for (sojourn d_prev, regime r_prev), entry [r, d-1].

    The sojourn is clamped to the table depth. The regime is clamped too:
    dead particle slots carry regime -1, which torch would wrap to the last
    row; their value is never used (they carry -inf weights), and the clamp
    keeps the lookup in bounds without relying on wrap-around.
    """
    R, W = rho_table.shape
    d_idx = torch.clamp(d_prev.long() - 1, 0, W - 1)
    r_idx = torch.clamp(r_prev.long(), 0, R - 1)
    return rho_table[r_idx, d_idx]
