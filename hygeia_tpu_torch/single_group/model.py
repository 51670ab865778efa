"""Single-group change-point model: parameter packing and densities.

Counterpart of hygeia_tpu/single_group/model.py. The latent state is
(d, r): sojourn time and methylation regime. theta packs, in order:

    theta[0 : R(R-1)]        row-wise off-diagonal softmax params of P
    theta[R(R-1) : R^2]      logit(omega)
    theta[R^2 : R(R+1)]      log(kappa)        (only if kappa not fixed)

``build_tables`` takes theta with leading batch axes (one theta per unit of
the engine) and gives tables with the same leading axes. omega and kappa
come from theta through ``inv_logit64``/``exp64`` in float64 and through
XLA's float32 ``exp`` (``ops/xla_f32.py``) in float32, and the hazard
tables from ops/hazard.py, so the tables have the same bits on the CPU and
on a CUDA card, and in float32 they are the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hygeia_tpu_torch.ops.distributions import (
    logit,
    mu_sigma_to_alpha_beta,
    row_softmax_offdiag,
)
from hygeia_tpu_torch.ops import xla_f32
from hygeia_tpu_torch.ops.hazard import exp64, hazard_table_with_grads, inv_logit64

_NEG_INF = float("-inf")


class SingleGroupModel(NamedTuple):
    """Static configuration (the hyperparameters of the model)."""

    n_regimes: int
    u: int  # minimum distance between change points
    kappa_fixed: bool
    d_max: int  # hazard table depth (sojourns clamp here)
    alpha: torch.Tensor  # (R,)
    beta: torch.Tensor  # (R,)
    kappa0: torch.Tensor  # (R,) fixed kappa values (used when kappa_fixed)

    @property
    def dim_theta(self) -> int:
        R = self.n_regimes
        return R * R if self.kappa_fixed else R * (R + 1)


class ThetaTables(NamedTuple):
    """Everything derived from theta, rebuilt on each parameter update.
    Shapes carry theta's leading axes in front."""

    P: torch.Tensor  # (..., R, R) transition matrix, zero diagonal
    log_P: torch.Tensor  # (..., R, R), -inf diagonal
    omega: torch.Tensor  # (..., R)
    kappa: torch.Tensor  # (..., R)
    rho: torch.Tensor  # (..., R, d_max)
    exit_status: torch.Tensor  # (..., R, d_max) bool
    grad_omega_log_rho: torch.Tensor  # (..., R, d_max)
    grad_kappa_log_rho: torch.Tensor  # (..., R, d_max) (zeros when kappa fixed)


def make_model(mu, sigma, u, kappa, *, device, kappa_fixed=True, d_max=4096,
               dtype=torch.float32):
    """The static model config from the CLI-level parameters."""
    mu = torch.as_tensor(np.asarray(mu, np.float64), dtype=dtype, device=device)
    sigma = torch.as_tensor(np.asarray(sigma, np.float64), dtype=dtype, device=device)
    alpha, beta = mu_sigma_to_alpha_beta(mu, sigma)
    return SingleGroupModel(
        n_regimes=int(mu.shape[0]),
        u=int(u),
        kappa_fixed=bool(kappa_fixed),
        d_max=int(d_max),
        alpha=alpha,
        beta=beta,
        kappa0=torch.as_tensor(np.asarray(kappa, np.float64), dtype=dtype, device=device),
    )


def model_from_numpy(d, theta, *, device, dtype=torch.float64):
    """(SingleGroupModel, theta tensor) from the JAX package's
    ``SingleGroupModel._asdict()`` with its arrays as numpy, and a theta
    vector: the tests hand both packages the same model and theta."""
    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    model = SingleGroupModel(
        n_regimes=int(d["n_regimes"]),
        u=int(d["u"]),
        kappa_fixed=bool(d["kappa_fixed"]),
        d_max=int(d["d_max"]),
        alpha=t(d["alpha"]),
        beta=t(d["beta"]),
        kappa0=t(d["kappa0"]),
    )
    return model, t(theta)


def build_tables(model: SingleGroupModel, theta) -> ThetaTables:
    """theta (..., D) -> (P, omega, kappa) + hazard and gradient tables."""
    R = model.n_regimes
    dtype = theta.dtype
    P = row_softmax_offdiag(theta[..., : R * (R - 1)], R)
    log_P = torch.where(P > 0.0, torch.log(P), _NEG_INF)
    f32 = dtype == torch.float32
    th_omega = theta[..., R * (R - 1) : R * R]
    omega = xla_f32.inv_logit(th_omega) if f32 else inv_logit64(th_omega).to(dtype)
    if model.kappa_fixed:
        kappa = model.kappa0.to(dtype).expand(omega.shape)
    else:
        th_kappa = theta[..., R * R : R * (R + 1)]
        kappa = xla_f32.exp(th_kappa) if f32 else exp64(th_kappa).to(dtype)
    haz = hazard_table_with_grads(
        kappa, omega, model.u, model.d_max, kappa_fixed=model.kappa_fixed, dtype=dtype
    )
    gk = haz["grad_kappa_log_rho"]
    if gk is None:
        gk = torch.zeros_like(haz["grad_omega_log_rho"])
    return ThetaTables(
        P=P,
        log_P=log_P,
        omega=omega,
        kappa=kappa,
        rho=haz["rho"],
        exit_status=haz["exit_status"],
        grad_omega_log_rho=haz["grad_omega_log_rho"],
        grad_kappa_log_rho=gk,
    )


def parameters_to_theta(P, omega, kappa=None, kappa_fixed=True):
    """(P, omega, kappa) -> theta as a float64 numpy vector: log of the
    off-diagonal P entries (row-major), logit(omega), and log(kappa) when
    estimated."""
    P = np.asarray(P, np.float64)
    R = P.shape[0]
    offdiag = np.array([np.log(P[r, c]) for r in range(R) for c in range(R) if c != r])
    om = logit(torch.as_tensor(np.asarray(omega, np.float64))).numpy()
    theta = np.concatenate([offdiag, om])
    if not kappa_fixed:
        theta = np.concatenate([theta, np.log(np.asarray(kappa, np.float64))])
    return theta


def theta_to_parameters(theta, n_regimes, kappa_fixed=True):
    """theta -> dict(p, p_non_diag, omega[, kappa]) as float64 numpy."""
    R = n_regimes
    theta = torch.as_tensor(np.asarray(theta, np.float64))
    P = row_softmax_offdiag(theta[: R * (R - 1)], R).numpy()
    out = {
        "p": P,
        "p_non_diag": np.array([P[r, c] for r in range(R) for c in range(R) if c != r]),
        "omega": (1.0 / (1.0 + torch.exp(-theta[R * (R - 1) : R * R]))).numpy(),
    }
    if not kappa_fixed:
        out["kappa"] = np.exp(theta[R * R : R * (R + 1)].numpy())
    return out


def _lookup(tables: ThetaTables, d_prev, r_prev):
    """(rho, exit) at sojourn d_prev (clamped to the table) and regime r_prev
    (clamped to [0, R)), for tables without batch axes."""
    R, W = tables.rho.shape
    d_idx = torch.clamp(d_prev.long() - 1, 0, W - 1)
    r_idx = torch.clamp(r_prev.long(), 0, R - 1)
    return tables.rho[r_idx, d_idx], tables.exit_status[r_idx, d_idx]


def continuation_log_density(tables: ThetaTables, d_prev, r_prev):
    """log f((d_prev+1, r_prev) | (d_prev, r_prev)) = log(1 - rho); -inf on
    the exit latch or where rho numerically exceeds 1."""
    rho, exit_s = _lookup(tables, d_prev, r_prev)
    return torch.where(exit_s | (rho > 1.0), _NEG_INF, torch.log1p(-rho))


def change_point_log_density(tables: ThetaTables, u, r_new, d_prev, r_prev):
    """log f((1, r_new) | (d_prev, r_prev)) for r_new != r_prev, d_prev >= u:
    log rho + log P[r_prev, r_new]; the log rho term is dropped on the exit
    latch. Shapes broadcast."""
    rho, exit_s = _lookup(tables, d_prev, r_prev)
    R = tables.log_P.shape[0]
    log_rho_term = torch.where(exit_s, 0.0, torch.log(rho))
    valid = (r_new != r_prev) & (d_prev >= u)
    log_p = tables.log_P[torch.clamp(r_prev.long(), 0, R - 1), torch.clamp(r_new.long(), 0, R - 1)]
    return torch.where(valid, log_rho_term + log_p, _NEG_INF)
