"""Elementary log-densities and the transition-matrix packing, on tensors.

Counterpart of hygeia_tpu/ops/distributions.py; the same formulas with
``torch.lgamma`` in place of ``gammaln``. All functions broadcast. In
float32 the log-pmfs take XLA's CPU ``lgamma``, ``log`` and ``log1p``
(``ops/xla_f32.py``), so they are the JAX package's float32 values bit for
bit, on the CPU and on a card alike.
"""

from __future__ import annotations

import torch

from hygeia_tpu_torch.ops import xla_f32

_NEG_INF = float("-inf")


def logit(x):
    """log(x / (1-x))."""
    return torch.log(x) - torch.log1p(-x)


def inv_logit(x):
    """Logistic function 1/(1+exp(-x))."""
    return 1.0 / (1.0 + torch.exp(-x))


def mu_sigma_to_alpha_beta(mu, sigma):
    """(mean, sd) of a Beta law -> shape parameters (alpha, beta).

    nu = mu(1-mu)/sigma^2 - 1; alpha = mu*nu; beta = (1-mu)*nu.
    """
    nu = mu * (1.0 - mu) / (sigma**2) - 1.0
    return mu * nu, (1.0 - mu) * nu


def beta_binomial_log_pmf(x, n, alpha, beta):
    """Log-pmf of BetaBinomial(n; alpha, beta) at x; -inf outside 0 <= x <= n."""
    lg = xla_f32.lgamma if torch.result_type(n, alpha) == torch.float32 else torch.lgamma
    lp = (
        lg(n + 1.0)
        - lg(x + 1.0)
        - lg(n - x + 1.0)
        + lg(x + alpha)
        + lg(n - x + beta)
        - lg(n + alpha + beta)
        + lg(alpha + beta)
        - lg(alpha)
        - lg(beta)
    )
    valid = (x >= 0) & (x <= n)
    return torch.where(valid, lp, _NEG_INF)


def neg_binomial_log_pmf(x, size, prob):
    """Log-pmf of NegativeBinomial(size, success prob) at count x >= 0,
    with the point mass at 0 when prob == 0."""
    f32 = torch.result_type(x, prob) == torch.float32
    lg = xla_f32.lgamma if f32 else torch.lgamma
    log, log1p = (xla_f32.log, xla_f32.log1p) if f32 else (torch.log, torch.log1p)
    lp = (
        lg(x + size)
        - lg(size)
        - lg(x + 1.0)
        + size * log1p(-prob)
        + x * log(prob)
    )
    lp = torch.where(prob == 0.0, torch.where(x == 0.0, 0.0, _NEG_INF), lp)
    return torch.where(x >= 0, lp, _NEG_INF)


def row_softmax_offdiag(theta_p, n_regimes):
    """The (R, R) transition matrix P from the R(R-1) packed off-diagonal
    softmax parameters (row-major); leading axes are batch axes.

    Row r of P is the softmax of its R-1 off-diagonal entries; the diagonal
    is 0."""
    R = n_regimes
    rows = torch.softmax(theta_p.reshape(*theta_p.shape[:-1], R, R - 1), dim=-1)
    # cols[r, j]: the column of row r's j-th off-diagonal entry, made on the
    # device (a captured parameter update builds P; a host copy is refused).
    j = torch.arange(R - 1, device=theta_p.device)
    cols = j + (j >= torch.arange(R, device=theta_p.device)[:, None])
    P = torch.zeros((*rows.shape[:-1], R), dtype=rows.dtype, device=rows.device)
    return P.scatter_(-1, cols.expand(rows.shape), rows)
