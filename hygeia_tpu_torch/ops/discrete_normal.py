"""Discrete-normal distribution family (off the reference's main path).

Counterpart of hygeia_tpu/ops/discrete_normal.py: P(X = x) = Phi(x+1) -
Phi(x) for integer x, Phi the N(mean, sd) CDF, with left-, right- and
doubly truncated variants and their gradients with respect to the mean,
the standard deviation and (left and doubly truncated) the variance.
Elementwise tensor functions; run them in float64, as the reference's
double precision and the JAX package's tests do.

The reference's quirks are kept word for word, as in the JAX module:

* a log CDF difference falls back to the survival-function difference
  when the CDF difference underflows, log(1 - Phi(x)) to the log survival
  function;
* every guarded gradient is 0.0 where the formula is not finite;
* every gradient carries one extra ``/sd`` against d/dparam log p, and
  the untruncated family's also has its sign flipped.

Phi and log Phi are the JAX package's algorithms (``jax.scipy.special``'s
``ndtr`` and ``log_ndtr``: erf near 0, erfc in the tails; log of ndtr
between -20 and 8, -ndtr(-x) above, a three-term asymptotic series below)
written on ``torch.special.erf`` and ``erfc``, so that the port holds
rtol 1e-12 of the JAX functions in the tails too. ``torch.special.ndtr``
cannot stand in for them: on the CPU it is 0 from x = -8.5 on and 4e-11
off at x = -5 (torch 2.13); ``torch.special.log_ndtr`` is more accurate than
JAX's near 8 and below -20, which is not the JAX package's value either.
"""

from __future__ import annotations

import math

import torch

_NEG_INF = float("-inf")
_HALF_SQRT_2 = 0.5 * math.sqrt(2.0)
_LOG_NDTR_LOWER, _LOG_NDTR_UPPER = -20.0, 8.0  # float64 segments
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _t(x):
    return torch.as_tensor(x, dtype=torch.float64) if not isinstance(x, torch.Tensor) else x


def ndtr(x):
    """The standard normal CDF (jax.scipy.special.ndtr's algorithm)."""
    w = x * _HALF_SQRT_2
    z = torch.abs(w)
    y = torch.where(z < _HALF_SQRT_2, 1.0 + torch.special.erf(w),
                    torch.where(w > 0.0, 2.0 - torch.special.erfc(z), torch.special.erfc(z)))
    return 0.5 * y


def _log_ndtr_lower(x):
    """log Phi(x) for x << -1: the asymptotic series of order 3."""
    x2 = x * x
    log_scale = -0.5 * x2 - torch.log(-x) - _HALF_LOG_2PI
    odd = 1.0 / x2 + 15.0 / (x2 * x2 * x2)
    even = 3.0 / (x2 * x2)
    return log_scale + torch.log(1.0 + even - odd)


def log_ndtr(x):
    """log Phi(x) (jax.scipy.special.log_ndtr's algorithm at float64)."""
    return torch.where(
        x > _LOG_NDTR_UPPER,
        -ndtr(-x),
        torch.where(x > _LOG_NDTR_LOWER, torch.log(ndtr(torch.clamp(x, min=_LOG_NDTR_LOWER))),
                    _log_ndtr_lower(torch.clamp(x, max=_LOG_NDTR_LOWER))),
    )


def _std(x, mean, sd):
    return (_t(x).to(torch.float64) - mean) / sd


def log_diff_cdfs(x1, x2, mean, sd):
    """log(Phi(x1) - Phi(x2)) with the survival-function fallback for the
    deep upper tail."""
    z1, z2 = _std(x1, mean, sd), _std(x2, mean, sd)
    y = torch.log(ndtr(z1) - ndtr(z2))
    y_sf = torch.log(ndtr(-z2) - ndtr(-z1))
    return torch.where(torch.isfinite(y), y, y_sf)


def log_one_minus_cdf(x, mean, sd):
    """log(1 - Phi(x)) with the log-survival fallback."""
    z = _std(x, mean, sd)
    y = torch.log(1.0 - ndtr(z))
    return torch.where(torch.isfinite(y), y, log_ndtr(-z))


def _pdf(x, mean, sd):
    """N(mean, sd) density at x, as jax.scipy.stats.norm.pdf(z) / sd
    computes it: exp(-(log(2 pi) + z^2) / 2) / sd."""
    z = _std(x, mean, sd)
    return torch.exp((math.log(2.0 * math.pi) + z * z) / -2.0) / sd


def _guard(grad):
    """The reference's isfinite-else-0.0 gradient guard."""
    return torch.where(torch.isfinite(grad), grad, 0.0)


# Untruncated discrete normal.


def log_density(x, mean, sd):
    """log P(X = x) = log(Phi(x+1) - Phi(x))."""
    x = _t(x)
    return log_diff_cdfs(x + 1, x, mean, sd)


def grad_mean_log_density(x, mean, sd):
    """d/dmean log P(X = x) (not guarded, as in the reference)."""
    x = _t(x)
    num = _pdf(x + 1, mean, sd) - _pdf(x, mean, sd)
    return (num / torch.exp(log_diff_cdfs(x + 1, x, mean, sd))) / sd


def _weighted_pdf_diff(x_hi, x_lo, mean, sd):
    """phi(x_hi)*(x_hi-mean) - phi(x_lo)*(x_lo-mean)."""
    return _pdf(x_hi, mean, sd) * (x_hi - mean) - _pdf(x_lo, mean, sd) * (x_lo - mean)


def grad_sd_log_density(x, mean, sd):
    """d/dsd log P(X = x), guarded."""
    x = _t(x)
    num = _weighted_pdf_diff(x + 1, x, mean, sd)
    grad = (num / torch.exp(log_diff_cdfs(x + 1, x, mean, sd))) / (sd * sd)
    return _guard(grad)


# Left-truncated discrete normal: support {lower, lower+1, ...}.


def log_density_left_truncated(x, lower, mean, sd):
    """-inf below the truncation point."""
    x = _t(x)
    lp = log_diff_cdfs(x + 1, x, mean, sd) - log_one_minus_cdf(lower, mean, sd)
    return torch.where(x < lower, _NEG_INF, lp)


def _left_boundary_ratio(lower, mean, sd):
    return (0.0 - _pdf(lower, mean, sd)) / torch.exp(log_one_minus_cdf(lower, mean, sd))


def _x_ratio(x, mean, sd):
    return (_pdf(x + 1, mean, sd) - _pdf(x, mean, sd)) / torch.exp(log_diff_cdfs(x + 1, x, mean, sd))


def _x_weighted_ratio(x, mean, sd):
    return _weighted_pdf_diff(x + 1, x, mean, sd) / torch.exp(log_diff_cdfs(x + 1, x, mean, sd))


def grad_mean_log_density_left_truncated(x, lower, mean, sd):
    """0.0 below the truncation point, guarded."""
    x = _t(x)
    grad = (_left_boundary_ratio(lower, mean, sd) - _x_ratio(x, mean, sd)) / sd
    return torch.where(x < lower, 0.0, _guard(grad))


def _left_weighted_boundary_ratio(lower, mean, sd):
    return (0.0 - _pdf(lower, mean, sd) * (lower - mean)) / torch.exp(log_one_minus_cdf(lower, mean, sd))


def grad_var_log_density_left_truncated(x, lower, mean, sd):
    """Gradient with respect to the variance (divides by 2 sd^3)."""
    x = _t(x)
    num = _left_weighted_boundary_ratio(lower, mean, sd) - _x_weighted_ratio(x, mean, sd)
    grad = num / (2.0 * sd * sd * sd)
    return torch.where(x < lower, 0.0, _guard(grad))


def grad_sd_log_density_left_truncated(x, lower, mean, sd):
    """Gradient with respect to the standard deviation."""
    x = _t(x)
    num = _left_weighted_boundary_ratio(lower, mean, sd) - _x_weighted_ratio(x, mean, sd)
    grad = num / (sd * sd)
    return torch.where(x < lower, 0.0, _guard(grad))


# Right-truncated discrete normal: support {..., upper-1, upper}.


def log_density_right_truncated(x, upper, mean, sd):
    """The normaliser is the log-CDF itself, log Phi(upper + 1)."""
    x = _t(x)
    lp = torch.log(ndtr(_std(x + 1, mean, sd)) - ndtr(_std(x, mean, sd))) - log_ndtr(_std(upper + 1, mean, sd))
    return torch.where(x > upper, _NEG_INF, lp)


def grad_mean_log_density_right_truncated(x, upper, mean, sd):
    """Plain CDF ratios (no log-difference fallback), guarded."""
    x = _t(x)
    bound = (_pdf(upper + 1, mean, sd) - 0.0) / (ndtr(_std(upper + 1, mean, sd)) - 0.0)
    own = (_pdf(x + 1, mean, sd) - _pdf(x, mean, sd)) / (ndtr(_std(x + 1, mean, sd)) - ndtr(_std(x, mean, sd)))
    grad = (bound - own) / sd
    return torch.where(x > upper, 0.0, _guard(grad))


def grad_sd_log_density_right_truncated(x, upper, mean, sd):
    x = _t(x)
    bound = (_pdf(upper + 1, mean, sd) * (upper + 1 - mean) - 0.0) / (ndtr(_std(upper + 1, mean, sd)) - 0.0)
    own = _weighted_pdf_diff(x + 1, x, mean, sd) / (ndtr(_std(x + 1, mean, sd)) - ndtr(_std(x, mean, sd)))
    grad = (bound - own) / (sd * sd)
    return torch.where(x > upper, 0.0, _guard(grad))


# Doubly truncated discrete normal: support {lower, ..., upper}.


def log_density_truncated(x, lower, upper, mean, sd):
    x = _t(x)
    lp = log_diff_cdfs(x + 1, x, mean, sd) - log_diff_cdfs(upper + 1, lower, mean, sd)
    return torch.where((x < lower) | (x > upper), _NEG_INF, lp)


def _double_boundary_ratio(lower, upper, mean, sd):
    num = _pdf(upper + 1, mean, sd) - _pdf(lower, mean, sd)
    return num / torch.exp(log_diff_cdfs(upper + 1, lower, mean, sd))


def _double_weighted_boundary_ratio(lower, upper, mean, sd):
    num = _pdf(upper + 1, mean, sd) * (upper + 1 - mean) - _pdf(lower, mean, sd) * (lower - mean)
    return num / torch.exp(log_diff_cdfs(upper + 1, lower, mean, sd))


def grad_mean_log_density_truncated(x, lower, upper, mean, sd):
    x = _t(x)
    grad = (_double_boundary_ratio(lower, upper, mean, sd) - _x_ratio(x, mean, sd)) / sd
    return torch.where((x < lower) | (x > upper), 0.0, _guard(grad))


def grad_sd_log_density_truncated(x, lower, upper, mean, sd):
    x = _t(x)
    num = _double_weighted_boundary_ratio(lower, upper, mean, sd) - _x_weighted_ratio(x, mean, sd)
    grad = num / (sd * sd)
    return torch.where((x < lower) | (x > upper), 0.0, _guard(grad))


def grad_var_log_density_truncated(x, lower, upper, mean, sd):
    """Gradient with respect to the variance (2 sd^3 denominator)."""
    x = _t(x)
    num = _double_weighted_boundary_ratio(lower, upper, mean, sd) - _x_weighted_ratio(x, mean, sd)
    grad = num / (2.0 * sd * sd * sd)
    return torch.where((x < lower) | (x > upper), 0.0, _guard(grad))
