"""Generative simulation of the two-group model (the ``simulate_two_groups``
verb and test fixtures).

Counterpart of hygeia_tpu/two_group/simulate.py: the joint (m, d_c, r_c,
d_k, r_k) chain rolled forward on the parameters' device, sampled from the
transition *density* the filter targets (branches a-d of the case state),
then BetaBinomial read counts.

Randomness. The chain's noise is drawn up front, one call per array, from
a ``torch.Generator`` on the device (``draw_chain_noise``), or handed in as
``noise=`` (``ChainNoise``): a test feeds the draws the JAX package derives
from its threefry keys, and the states are then JAX's exactly. Every
categorical is a Gumbel-max, ``argmax(gumbel + logits)`` with the first
maximum on ties, as ``jax.random.categorical`` draws it; a jump is
``u < rho``. The site loop is a step that reads its site from a device
index and writes its carry in place, with no ``.item()`` and no host
sync, so on a CUDA device it replays as CUDA graphs (ops/site_graphs.py;
the JAX module's chain is a ``lax.scan``).

The observations are Beta draws as G1 / (G1 + G2) of two standard Gamma
draws, then Binomial draws, all from the same generator, in float64 (a
Gamma draw of shape 0.03 underflows float32 about one time in fifteen).
They are not injectable: the JAX package's Beta and Binomial samplers are
not reproduced, only their laws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hygeia_tpu_torch.ops.hazard import gather_rho
from hygeia_tpu_torch.ops.site_graphs import SITES_PER_GRAPH, SiteLoop
from hygeia_tpu_torch.two_group.backward import gumbel
from hygeia_tpu_torch.two_group.model import State, TwoGroupParams

_NEG_INF = float("-inf")


class SimulationResult(NamedTuple):
    states: torch.Tensor  # (T, 5) int32 (m, d_c, r_c, d_k, r_k)
    obs_control: torch.Tensor  # (T, S_c) int32 methylated read counts
    obs_case: torch.Tensor  # (T, S_k) int32


class ChainNoise(NamedTuple):
    """The chain's draws; row t serves site t (row 0 of ``g_m`` is unused:
    site 0 is merged)."""

    phantom_r: torch.Tensor  # () int: the phantom previous regime
    g_m: torch.Tensor  # (T, 2) Gumbel noise of the merged-indicator draw
    u_c: torch.Tensor  # (T,) uniform of the control jump
    g_cr: torch.Tensor  # (T, R) Gumbel noise of the new control regime
    u_k: torch.Tensor  # (T,) uniform of the case jump
    g_kr: torch.Tensor  # (T, R) Gumbel noise: a case regime other than r_c
    g_kr2: torch.Tensor  # (T, R) Gumbel noise: other than r_c and the previous r_k


def draw_chain_noise(T, R, *, generator, device, dtype=torch.float32) -> ChainNoise:
    """Every draw of a T-site chain, one call per array."""
    return ChainNoise(
        phantom_r=torch.randint(0, R, (), generator=generator, device=device),
        g_m=gumbel((T, 2), generator=generator, dtype=dtype, device=device),
        u_c=torch.rand((T,), generator=generator, dtype=dtype, device=device),
        g_cr=gumbel((T, R), generator=generator, dtype=dtype, device=device),
        u_k=torch.rand((T,), generator=generator, dtype=dtype, device=device),
        g_kr=gumbel((T, R), generator=generator, dtype=dtype, device=device),
        g_kr2=gumbel((T, R), generator=generator, dtype=dtype, device=device),
    )


def _argmax(noise, logits):
    """Gumbel-max categorical draws along the last axis: the first maximum
    of noise + logits."""
    return torch.argmax(noise + logits, dim=-1).to(torch.int32)


def sample_transition(params: TwoGroupParams, prev: State, noise, *, step0=False) -> State:
    """The next states of ``prev`` (int32 fields of one broadcast shape K)
    under the transition density, given one site's noise
    (g_m (K, 2), u_c (K,), g_cr (K, R), u_k (K,), g_kr (K, R), g_kr2 (K, R),
    or without the K axis); step0 is the first site, drawn from the
    phantom state: merged, and both groups jump."""
    g_m, u_c, g_cr, u_k, g_kr, g_kr2 = noise
    R = params.n_regimes
    dev = params.device
    one = torch.ones((), dtype=torch.int32, device=dev)
    if step0:
        m = torch.ones_like(prev.m)
        rho_c = rho_k = torch.ones((), dtype=params.dtype, device=dev)
    else:
        gate = torch.minimum(prev.d_k, prev.d_c) >= params.min_duration
        m = torch.where(gate, _argmax(g_m, params.log_p_merged[prev.m.long()]), prev.m)
        rho_c = gather_rho(params.rho_control, prev.d_c, prev.r_c)
        rho_k = gather_rho(params.rho_case, prev.d_k, prev.r_k)
    jump_c = u_c < rho_c
    new_rc = _argmax(g_cr, params.log_p_control[torch.clamp(prev.r_c.long(), 0, R - 1)])
    d_c = torch.where(jump_c, one, prev.d_c + 1)
    r_c = torch.where(jump_c, new_rc, prev.r_c)

    regimes = torch.arange(R, device=dev)
    zero = torch.zeros((), dtype=g_kr.dtype, device=dev)
    neg = torch.full((), _NEG_INF, dtype=g_kr.dtype, device=dev)
    not_c = regimes != r_c[..., None]
    samp_not_c = _argmax(g_kr, torch.where(not_c, zero, neg))
    samp_not_both = _argmax(g_kr2, torch.where(not_c & (regimes != prev.r_k[..., None]), zero, neg))
    jump_k = u_k < rho_k
    in_a = m == 1
    in_b = (prev.m == 1) & (d_c != 1)
    in_c = (r_c == prev.r_k) & (prev.m == 0)
    d_k = torch.where(in_a, d_c, torch.where(in_b | in_c | jump_k, one, prev.d_k + 1))
    r_k = torch.where(
        in_a, r_c,
        torch.where(in_b, samp_not_c, torch.where(in_c | jump_k, samp_not_both, prev.r_k)),
    )
    return State(m=m.to(torch.int32), d_c=d_c, r_c=r_c, d_k=d_k, r_k=r_k)


def simulate_chain(params: TwoGroupParams, noise: ChainNoise,
                   sites_per_graph: int = SITES_PER_GRAPH) -> torch.Tensor:
    """(T, 5) int32 states of the joint chain, on the parameters' device.

    Site 0 (drawn from the phantom state) runs eagerly; sites 1..T-1 run
    as ``_chain_step``, on a CUDA device through CUDA graphs of
    ``sites_per_graph`` sites (0: eagerly, only to compare the two; the
    same states either way), on the CPU eagerly."""
    dev = params.device
    nz = ChainNoise(*(torch.as_tensor(x, device=dev) for x in noise))
    T = nz.u_c.shape[0]
    # One state, carried with a leading axis of 1: a 0-dim index tensor is
    # read on the host, which a captured step may not do.
    r = nz.phantom_r.to(torch.int32).reshape(1)
    z = torch.zeros_like(r)
    prev = State(m=torch.ones_like(r), d_c=z, r_c=r, d_k=z, r_k=r)  # the phantom state
    states = torch.empty((T, 5), dtype=torch.int32, device=dev)
    if T == 0:
        return states
    first = sample_transition(params, prev, tuple(x[:1] for x in nz[1:]), step0=True)
    states[:1] = torch.stack(first, dim=-1)
    carry = tuple(f.clone() for f in first)
    t = torch.ones((1,), dtype=torch.int64, device=dev)  # the next site
    with SiteLoop(dev, sites_per_graph) as loop:
        loop.run(lambda: _chain_step(params, nz, t, carry, states), T - 1)
    return states


def _chain_step(params, nz: ChainNoise, t, carry, states):
    """Site t of the chain, replayable as a CUDA graph: row t of each noise
    array and of ``states`` through the device index ``t``, which the
    step then advances; the carried state (five (1,) int32 tensors)
    overwritten in place."""
    nxt = sample_transition(params, State(*carry), tuple(x.index_select(0, t) for x in nz[1:]))
    states.index_copy_(0, t, torch.stack(nxt, dim=-1))
    for c, f in zip(carry, nxt):
        c.copy_(f)
    t.add_(1)


def sample_beta_binomial(n_total, alpha, beta, *, generator):
    """BetaBinomial counts (int32, n_total's shape) with per-row shapes
    alpha, beta (T, 1): p = G1 / (G1 + G2), then Binomial(n_total, p), in
    float64 on n_total's device."""
    n = n_total.to(torch.float64)
    a = alpha.to(torch.float64).expand(n.shape).contiguous()
    b = beta.to(torch.float64).expand(n.shape).contiguous()
    g1 = torch._standard_gamma(a, generator=generator)
    g2 = torch._standard_gamma(b, generator=generator)
    p = g1 / (g1 + g2)
    return torch.binomial(n, p, generator=generator).to(torch.int32)


def simulate(params: TwoGroupParams, n_total_control, n_total_case, *, generator,
             noise: ChainNoise | None = None) -> SimulationResult:
    """Roll the joint chain forward and emit BetaBinomial read counts.

    n_total_control (T, S_c), n_total_case (T, S_k): total reads, moved to
    the parameters' device. The chain takes ``noise`` when given, else
    draws it from ``generator`` (on that device); the observations always
    come from ``generator``."""
    dev = params.device
    n_c = torch.as_tensor(n_total_control, device=dev)
    n_k = torch.as_tensor(n_total_case, device=dev)
    T = n_c.shape[0]
    if noise is None:
        noise = draw_chain_noise(T, params.n_regimes, generator=generator, device=dev,
                                 dtype=params.dtype)
    states = simulate_chain(params, noise)
    r_c = states[:, 2].long()
    r_k = states[:, 4].long()
    obs_c = sample_beta_binomial(n_c, params.alpha[r_c][:, None], params.beta[r_c][:, None],
                                 generator=generator)
    obs_k = sample_beta_binomial(n_k, params.alpha[r_k][:, None], params.beta[r_k][:, None],
                                 generator=generator)
    return SimulationResult(states=states, obs_control=obs_c, obs_case=obs_k)
