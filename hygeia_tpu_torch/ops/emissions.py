"""Per-site emission log-likelihood tables.

Counterpart of hygeia_tpu/ops/emissions.py::emission_log_prob_table:

    E[t, r] = sum_s log BetaBinomial(y[t, s]; n[t, s], alpha_r, beta_r)

one (T, R) table per group; the filter gathers E[t, r_particle].
"""

from __future__ import annotations

import torch

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
    return torch.sum(beta_binomial_log_pmf(y, n, a, b), dim=1)
