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
generator (two_group.simulate.sample_beta_binomial). The chain's site
loop is a step that reads its site from a device index and writes its
carry in place, so on a CUDA device it replays as CUDA graphs
(ops/site_graphs.py; the JAX module's chain is a ``lax.scan``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hygeia_tpu_torch.ops.site_graphs import SITES_PER_GRAPH, SiteLoop
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


def simulate_chain(model: SingleGroupModel, theta, noise: ChainNoise, sites_per_graph: int = SITES_PER_GRAPH):
    """(d, r), each (T,) int32, on theta's device. Site 0 is set before the
    loop; sites 1..T-1 run as ``_chain_step``, on a CUDA device through
    CUDA graphs of ``sites_per_graph`` sites (0: eagerly, only to compare
    the two; the same states either way), on the CPU eagerly."""
    tables = build_tables(model, theta)
    dev = theta.device
    nz = ChainNoise(*(torch.as_tensor(x, device=dev) for x in noise))
    T = nz.u.shape[0] + 1
    # The state is carried with a leading axis of 1: a 0-dim index tensor is
    # read on the host, which a captured step may not do.
    d = torch.ones((1,), dtype=torch.int32, device=dev)
    r = nz.r0.to(torch.int32).reshape(1).clone()
    ds = torch.empty((T,), dtype=torch.int32, device=dev)
    rs = torch.empty((T,), dtype=torch.int32, device=dev)
    ds[:1], rs[:1] = d, r
    t = torch.ones((1,), dtype=torch.int64, device=dev)  # the next site
    with SiteLoop(dev, sites_per_graph) as loop:
        loop.run(lambda: _chain_step(model, tables, nz, t, d, r, ds, rs), T - 1)
    return ds, rs


def _chain_step(model, tables, nz: ChainNoise, t, d, r, ds, rs):
    """Site t of the chain, replayable as a CUDA graph: the noise's row
    t - 1 and row t of ``ds`` and ``rs`` through the device index ``t``,
    which the step then advances; the state d, r ((1,) int32) overwritten
    in place."""
    R = model.n_regimes
    r_idx = torch.clamp(r.long(), 0, R - 1)
    rho = tables.rho[r_idx, torch.clamp(d.long() - 1, 0, model.d_max - 1)]
    row = t - 1
    jump = nz.u.index_select(0, row) <= rho
    new_r = torch.argmax(nz.g.index_select(0, row) + tables.log_P[r_idx], dim=-1).to(torch.int32)
    d_new = torch.where(jump, torch.ones_like(d), d + 1)
    r_new = torch.where(jump, new_r, r)
    ds.index_copy_(0, t, d_new)
    rs.index_copy_(0, t, r_new)
    d.copy_(d_new)
    r.copy_(r_new)
    t.add_(1)


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
