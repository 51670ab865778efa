"""Per-site emission log-likelihood tables.

Counterpart of hygeia_tpu/ops/emissions.py::emission_log_prob_table:

    E[t, r] = sum_s log BetaBinomial(y[t, s]; n[t, s], alpha_r, beta_r)

one (T, R) table per group; the filter gathers E[t, r_particle].

Both tables are JAX's operations one for one, and every sum adds in XLA's
CPU order (``xla_f32.reduce_sum``) at any dtype. In float32 every
transcendental is XLA's CPU one (``ops/xla_f32.py``), so the tables are
the JAX package's eager float32 tables bit for bit, on the CPU and on a
card; in float64 they are PyTorch's (rtol 1e-12 of JAX's).
"""

from __future__ import annotations

import torch

from hygeia_tpu_torch.ops import xla_f32
from hygeia_tpu_torch.ops.distributions import beta_binomial_log_pmf


def emission_log_prob_table(
    n_methylated, n_total, alpha, beta, *, dtype=torch.float32, device=None
):
    """Build the (T, R) emission table.

    Args:
      n_methylated, n_total: (T, S) read counts (arrays or tensors).
      alpha, beta: (R,) Beta shape parameters per regime.
      dtype: compute dtype (float64 for parity tests).
      device: where the table is built; defaults to alpha's device.

    Sites with zero total reads contribute log BB(0; 0, a, b) = 0.
    """
    if device is None and isinstance(alpha, torch.Tensor):
        device = alpha.device
    y = torch.as_tensor(n_methylated, dtype=dtype, device=device)[:, :, None]
    n = torch.as_tensor(n_total, dtype=dtype, device=device)[:, :, None]
    a = torch.as_tensor(alpha, dtype=dtype, device=device)[None, None, :]
    b = torch.as_tensor(beta, dtype=dtype, device=device)[None, None, :]
    return xla_f32.reduce_sum(beta_binomial_log_pmf(y, n, a, b), 1)


def robust_emission_log_prob_table(
    n_methylated, n_total, alpha, beta, beta_div=0.05, *, dtype=torch.float32, device=None,
    chunk_elements=1 << 24,
):
    """Robust (beta-divergence) emission table, the JAX package's
    ``robust_emission_log_prob_table``:

        s(y) = (1/b) f(y)^b - 1/(b+1) * sum_x f(x)^(b+1)

    of the BetaBinomial pmf f, summed over samples. The support sum runs
    over x = 0 .. max(n)-1 with max(n) taken over the whole table (which
    leaves out x = n at the deepest site, as the reference does).

    The (X, T, S, R) pmf tensor is built in chunks of sites holding at most
    ``chunk_elements`` values, each with the table's global max(n). The
    log-sum-exp over x and the sum over samples add in an order that does
    not depend on the chunking, so the table is the same bit for bit at
    any chunk size: XLA's, which depends on X and S alone. The log-sum-exp
    is ``jax.scipy.special.logsumexp``'s operation for operation.
    """
    if device is None and isinstance(alpha, torch.Tensor):
        device = alpha.device
    y = torch.as_tensor(n_methylated, dtype=dtype, device=device)
    n = torch.as_tensor(n_total, dtype=dtype, device=device)
    a = torch.as_tensor(alpha, dtype=dtype, device=device)
    b = torch.as_tensor(beta, dtype=dtype, device=device)
    bd = torch.as_tensor(beta_div, dtype=dtype, device=device)
    T, S = n.shape
    R = a.shape[0]
    X = max(int(n.max()) if n.numel() else 0, 1)
    x = torch.arange(X, dtype=dtype, device=device)[:, None, None, None]
    if dtype == torch.float32:
        exp, log, div = xla_f32.exp, xla_f32.log, xla_f32._div
    else:
        exp, log, div = torch.exp, torch.log, torch.div
    step = max(1, int(chunk_elements) // (X * S * R))
    out = torch.empty((T, R), dtype=dtype, device=device)
    for lo in range(0, T, step):
        hi = min(T, lo + step)
        yc, nc = y[lo:hi, :, None], n[lo:hi, :, None]
        lp_y = beta_binomial_log_pmf(yc, nc, a, b)  # (Tc, S, R)
        z = (bd + 1.0) * beta_binomial_log_pmf(x, nc[None], a, b)  # (X, Tc, S, R); -inf where x > n
        m = z.amax(dim=0)
        m = torch.where(torch.isfinite(m), m, 0.0)
        lse = log(xla_f32.reduce_sum(exp(z - m), 0).abs()) + m
        e_lse = exp(lse)
        integral = div(e_lse, (bd + 1.0).expand_as(e_lse))
        e_y = exp(bd * lp_y)
        out[lo:hi] = xla_f32.reduce_sum(div(e_y, bd.expand_as(e_y)) - integral, 1)
    return out
