"""Streamed (checkpointed) filter and backward simulation: O(block) memory.

Counterpart of hygeia_tpu/two_group/streaming.py::streamed_inference. The
monolithic path (runner.infer_segment) holds the whole (U, T, N) filter
history on the device, 15 bytes a particle-site (3.9 GB a seed at
T = 105,000, N = 2400). This module trades one extra filter sweep for one
W-site block of history:

1. Forward: block by block, run the filter with ``return_history=False``,
   warm-started from the previous block's final state, and keep only the
   final (U, N) state of every block but the last (the checkpoints).
2. Reverse: block by block from the right, re-run the block's filter from
   the previous checkpoint (or cold, block 0) with its history, then sample
   it with ``backward_simulation_conditioned`` against the first-site states
   of the block to its right (the last block draws its terminal from the
   final weights). Each block's (U, W, B, 5) trajectories are copied to the
   host as soon as they exist.

Realisations do not depend on the block layout. The filter generator's
state is saved at the start of every block in the forward sweep (and at the
start of the last block after it) and restored for each re-run, so a block
re-draws the uniforms it drew in the forward sweep; the backward generator
is consumed at sites T-1, T-2, ..., 0, the monolithic order. For the same
generators, the trajectories are the monolithic ``run_filter`` +
``backward_simulation``'s bit for bit, and so is logZ: the per-site shifts
of all blocks are summed as one (U, T-1) tensor, as the monolithic filter
sums them.

Not ported: the JAX module's program cache and AOT compilation (XLA
plumbing), and its 2-byte trajectory packing for the device-to-host copy
(``timings["pull"]`` measures that copy on the card).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hygeia_tpu_torch.ops.site_graphs import SITES_PER_GRAPH, _sync
from hygeia_tpu_torch.two_group.backward import backward_simulation_conditioned
from hygeia_tpu_torch.two_group.filter import run_filter


def block_bounds(T, block_size):
    """[(lo, hi), ...] of the W = min(block_size, T) site blocks of T sites."""
    W = int(min(block_size, T))
    return [(lo, min(lo + W, T)) for lo in range(0, T, W)]


def launches_per_call(T, block_size):
    """Filter steps (one resampler launch each) of a streamed call: the
    forward sweep runs every block but the last (block 0 from site 1), the
    reverse sweep every block; 2T - len_last - 2 with two blocks or more,
    T - 1 with one."""
    bounds = block_bounds(T, block_size)
    if len(bounds) == 1:
        return T - 1
    len_last = bounds[-1][1] - bounds[-1][0]
    return 2 * T - len_last - 2


def streamed_inference(
    params,
    emission_control,  # (T, R) shared, or (U, T, R) per unit
    emission_case,  # same shape as emission_control
    num_resampled_ancestors: int,
    num_samples_backward: int,
    *,
    n_units: int,
    generator: torch.Generator,
    backward_generator: torch.Generator,
    block_size: int = 16384,
    weight_dtype=torch.float32,
    phantom_regime=None,
    timings: dict | None = None,
    sites_per_graph: int = SITES_PER_GRAPH,
):
    """Returns (traj (U, T, B, 5) int32 numpy, log_z (U,) tensor,
    degenerate steps (U,) tensor).

    A unit is an independent (segment, seed) inference. With (T, R)
    emissions the units share one segment (seeds); with (U, T, R) each unit
    carries its own segment. Pass ``timings={}`` to get per-block walls in
    seconds (lists "fwd", "rev", "pull": forward block, re-run + backward,
    device-to-host copy) and "rerun_equals_checkpoint": for every block but
    the last, whether its re-run's final state equals its checkpoint bit
    for bit (compared only then: the comparison waits for the device).
    ``sites_per_graph``: the site loops' sites a CUDA graph on the
    card (0: eagerly, only to compare the two)."""
    U = int(n_units)
    M, B = num_resampled_ancestors, num_samples_backward
    dev = params.device
    T = emission_control.shape[-2]
    bounds = block_bounds(T, block_size)
    n_blocks = len(bounds)
    compare = timings is not None
    timings = {} if timings is None else timings
    for k in ("fwd", "rev", "pull", "rerun_equals_checkpoint"):
        timings.setdefault(k, [])

    def run_block(b, init, return_history):
        lo, hi = bounds[b]
        return run_filter(
            params, emission_control[..., lo:hi, :], emission_case[..., lo:hi, :], M,
            n_units=U, generator=generator, weight_dtype=weight_dtype,
            phantom_regime=phantom_regime, return_history=return_history, init_state=init,
            sites_per_graph=sites_per_graph,
        )

    # ---- forward checkpoint sweep ------------------------------------------
    gen_states = [None] * n_blocks
    ckpts = [None] * n_blocks  # final (lw (U, N), particles (U, 5, N) int32)
    for b in range(n_blocks - 1):
        gen_states[b] = generator.get_state()
        t0 = time.perf_counter()
        res = run_block(b, ckpts[b - 1] if b else None, False)
        ckpts[b] = (res.log_weights, torch.stack(res.particles, dim=1))
        _sync(dev)
        timings["fwd"].append(time.perf_counter() - t0)
    gen_states[-1] = generator.get_state()

    # ---- reverse conditioned-backward sweep --------------------------------
    traj_host = np.empty((U, T, B, 5), np.int32)
    shift_parts = [None] * n_blocks
    degen = torch.zeros((U,), dtype=torch.int64, device=dev)
    term = None
    for b in range(n_blocks - 1, -1, -1):
        lo, hi = bounds[b]
        t0 = time.perf_counter()
        generator.set_state(gen_states[b])
        res = run_block(b, ckpts[b - 1] if b else None, True)
        if compare and b < n_blocks - 1:
            lw_ck, parts_ck = ckpts[b]
            same = torch.equal(res.log_weights[:, -1], lw_ck) and all(
                torch.equal(f[:, -1].to(torch.int32), parts_ck[:, i]) for i, f in enumerate(res.particles)
            )
            timings["rerun_equals_checkpoint"].insert(0, bool(same))
        ckpts[b] = None
        traj = backward_simulation_conditioned(
            params, res.log_weights, res.particles, term, term is not None,
            num_simulations=B, generator=backward_generator, sites_per_graph=sites_per_graph,
        )
        shift_parts[b] = (res.init_shift, res.shifts)
        degen += res.degenerate_steps
        del res  # frees the block's (U, W, N) history
        term = traj[:, 0]
        _sync(dev)
        t1 = time.perf_counter()
        traj_host[:, lo:hi] = traj.cpu().numpy()
        t2 = time.perf_counter()
        del traj
        timings["rev"].insert(0, t1 - t0)
        timings["pull"].insert(0, t2 - t1)

    # logZ: block 0's first-step shift plus the shifts of sites 1..T-1 as
    # one (U, T-1) tensor, the monolithic filter's sum.
    pieces = [shift_parts[0][1]]
    for init_shift, shifts in shift_parts[1:]:
        pieces += [init_shift[:, None], shifts]
    log_z = shift_parts[0][0] + torch.cat(pieces, dim=1).sum(dim=-1)
    return traj_host, log_z, degen
