"""Generative simulation of the single-group model (the ``simulate_data``
verb).

Counterpart of hygeia_tpu/single_group/simulate.py: (d, r) rolled forward
on the model's device from d = 1, r ~ Uniform(R), with the hazard and
transition tables of ``model.build_tables`` (theta's dtype; float32 tables
are the JAX package's bit for bit), then BetaBinomial read counts.

Randomness as in two_group/simulate.py: the chain's noise is drawn up front
from a ``torch.Generator``, one call per array (``draw_chain_noise``), or
handed in as ``noise=`` so that a test can feed the JAX package's draws and
get its states exactly. Unlike the two-group sampler a jump here is
``u <= rho`` (the JAX module's rule). The observations come from the
generator (two_group.simulate.sample_beta_binomial).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hygeia_tpu_torch.single_group.model import SingleGroupModel, build_tables
from hygeia_tpu_torch.two_group.backward import gumbel
from hygeia_tpu_torch.two_group.simulate import sample_beta_binomial


class SingleGroupSimulation(NamedTuple):
    d: torch.Tensor  # (T,) int32 sojourn times
    r: torch.Tensor  # (T,) int32 regimes
    n_methylated: torch.Tensor  # (T, S) int32


class ChainNoise(NamedTuple):
    """The chain's draws; row t - 1 serves the step to site t."""

    r0: torch.Tensor  # () int: the first regime
    u: torch.Tensor  # (T - 1,) uniforms of the jumps
    g: torch.Tensor  # (T - 1, R) Gumbel noise of the new regimes


def draw_chain_noise(T, R, *, generator, device, dtype=torch.float32) -> ChainNoise:
    """Every draw of a T-site chain, one call per array."""
    return ChainNoise(
        r0=torch.randint(0, R, (), generator=generator, device=device),
        u=torch.rand((T - 1,), generator=generator, dtype=dtype, device=device),
        g=gumbel((T - 1, R), generator=generator, dtype=dtype, device=device),
    )


def simulate_chain(model: SingleGroupModel, theta, noise: ChainNoise):
    """(d, r), each (T,) int32, on theta's device."""
    tables = build_tables(model, theta)
    dev = theta.device
    nz = ChainNoise(*(torch.as_tensor(x, device=dev) for x in noise))
    T = nz.u.shape[0] + 1
    R = model.n_regimes
    d = torch.ones((), dtype=torch.int32, device=dev)
    r = nz.r0.to(torch.int32)
    ds = torch.empty((T,), dtype=torch.int32, device=dev)
    rs = torch.empty((T,), dtype=torch.int32, device=dev)
    ds[0], rs[0] = d, r
    for t in range(1, T):
        r_idx = torch.clamp(r.long(), 0, R - 1)
        rho = tables.rho[r_idx, torch.clamp(d.long() - 1, 0, model.d_max - 1)]
        jump = nz.u[t - 1] <= rho
        new_r = torch.argmax(nz.g[t - 1] + tables.log_P[r_idx]).to(torch.int32)
        d = torch.where(jump, torch.ones_like(d), d + 1)
        r = torch.where(jump, new_r, r)
        ds[t], rs[t] = d, r
    return ds, rs


def simulate(model: SingleGroupModel, theta, n_total_reads, *, generator,
             noise: ChainNoise | None = None) -> SingleGroupSimulation:
    """Roll (d, r) forward over the T sites of n_total_reads (T, S) and
    sample methylated read counts; everything on theta's device (a tensor
    in the model's dtype: float32 for the verb, as the JAX CLI runs)."""
    dev = theta.device
    n = torch.as_tensor(n_total_reads, device=dev)
    if noise is None:
        noise = draw_chain_noise(n.shape[0], model.n_regimes, generator=generator, device=dev,
                                 dtype=theta.dtype)
    d, r = simulate_chain(model, theta, noise)
    r_l = r.long()
    y = sample_beta_binomial(n, model.alpha[r_l][:, None], model.beta[r_l][:, None], generator=generator)
    return SingleGroupSimulation(d=d, r=r, n_methylated=y)
