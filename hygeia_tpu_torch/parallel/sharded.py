"""Meshed two-group INFER: genome windows x seeds as the shards of a mesh
over ``torch.distributed`` ranks.

Counterpart of hygeia_tpu/parallel/sharded.py. A unit is one (window,
seed) inference; a rank runs its shards' units as the leading unit axis of
one batched site loop (``run_filter`` with per-unit emission rows), in
chunks that fit the device's memory budget (``runner.memory_budget_bytes``
over ``runner.bytes_per_seed``). With one rank, every shard is a unit of
the one card's loops.

* ``boundary="halo"``: ``make_block_windows`` cuts the zero-padded
  chromosome into ``n_blocks`` windows of segment + 2 * buffer sites
  (n_blocks rounded up to a multiple of the genome axis); each (block,
  seed) unit runs the filter and the backward simulation alone, and the
  halo rows are trimmed on the device. No messages.
* ``boundary="exchange"``: genome shard g owns one window of bpd * segment
  sites, no halo. (1) A cold warmup filter over the window's last W sites
  (W = min(max(1, 2 * buffer), window)); its final state goes right. (2)
  The main filter warm-starts from the received state (shard 0
  cold-starts). (3) Backward round 1; its first-site states go left. (4)
  Backward round 2, conditioned on the received states (the last shard
  keeps round 1's draws: its round 2 would be unconditioned, the same law).

Padding rows (sites outside the chromosome) score exactly 0 in both
groups' tables: the tables themselves give zero-read rows f32 rounding
(BetaBinomial, ~1e-6) or a constant (robust: S (1/b - 1/(b+1)) a row), so
the rows are set to 0, as the halo scheme assumes.

RNG: every unit has its own generators, seeded with
``SeedSequence([stream, base_key, block, seed])`` (the window's first
block in exchange mode; streams 0 filter, 1 backward round 1, 2 warmup, 3
backward round 2, JAX's ``fold_in`` numbers). So a unit draws what it
would draw alone, on any rank, in any chunk, at any world size; on the CPU
its realisation is its one-unit run's bit for bit. (On a card a batched
reduction's order can depend on the number of units, so there equal
chunks give equal bits.) The JAX package folds keys instead: its
realisations differ from the port's.

Messages: between windows on one rank an index shift along the unit axis;
between ranks one ``all_gather`` per tensor of a message (two for the
right-going filter state, one for the left-going trajectory states) and
one ``gather`` to rank 0 per result tensor, staged through host tensors
under gloo. ``MESSAGES`` counts them: ``rounds`` at every world size,
``calls`` (torch.distributed calls) only between ranks; neither grows
with the world size. Rank 0 returns the results; the other ranks None.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from hygeia_tpu_torch.ops.emissions import emission_log_prob_table, robust_emission_log_prob_table
from hygeia_tpu_torch.ops.site_graphs import SITES_PER_GRAPH, _sync
from hygeia_tpu_torch.two_group.backward import backward_simulation, backward_simulation_conditioned
from hygeia_tpu_torch.two_group.filter import run_filter
from hygeia_tpu_torch.two_group.proposal import num_children
from hygeia_tpu_torch.two_group.runner import bytes_per_seed, memory_budget_bytes

# Generator streams of a unit: the filter (main filter in exchange mode),
# backward round 1, the exchange warmup, backward round 2.
FILTER, BACKWARD, WARMUP, BACKWARD2 = 0, 1, 2, 3


class Messages:
    """Of the last call: ``rounds``, its messages (each tensor sent right
    or left, each result gathered to rank 0), counted at every world size;
    ``calls``, the torch.distributed calls made for them (one a message
    between ranks, none with one rank)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.rounds = 0
        self.calls = 0


MESSAGES = Messages()


def make_block_windows(arr, segment_size, buffer_size, n_blocks):
    """(T, S) -> (n_blocks, segment_size + 2*buffer_size, S) with zero-padded
    edges; block b covers sites [b*S - B, (b+1)*S + B) of the padded genome."""
    T, S = arr.shape
    total = n_blocks * segment_size
    padded = np.zeros((total + 2 * buffer_size, S), arr.dtype)
    padded[buffer_size : buffer_size + T] = arr[:total]
    win = segment_size + 2 * buffer_size
    return np.stack([padded[b * segment_size : b * segment_size + win] for b in range(n_blocks)])


def unit_generator(device, stream, base_key, block, seed):
    """The generator of one unit's ``stream``."""
    g = torch.Generator(device=device)
    ss = np.random.SeedSequence([int(stream), int(base_key), int(block), int(seed)])
    g.manual_seed(int(ss.generate_state(1, np.uint32)[0]))
    return g


def window_tables(params, counts, n_sites, segment_size, buffer_size, n_blocks, robust_beta=None):
    """Control and case emission tables of the windows, (n_windows, win, R)
    each, in the parameters' dtype: windows of ``make_block_windows``
    (halo), or with ``buffer_size=None`` the n_blocks blocks joined into
    windows of ``segment_size`` sites (exchange: pass the window length and
    the number of windows). One table a window (the robust table's support
    bound is its window's max(n), as JAX builds it a block). Rows outside the
    chromosome's ``n_sites`` sites are exactly 0."""
    buf = 0 if buffer_size is None else buffer_size
    wins = [make_block_windows(np.asarray(a, np.float32), segment_size, buf, n_blocks) for a in counts]
    n_win, win = wins[0].shape[:2]
    pos = np.arange(n_win)[:, None] * segment_size - buf + np.arange(win)[None, :]
    pad = torch.as_tensor((pos < 0) | (pos >= n_sites), device=params.device)[..., None]

    def table(y, n):
        if robust_beta is None:
            return emission_log_prob_table(y, n, params.alpha, params.beta, dtype=params.dtype)
        return robust_emission_log_prob_table(y, n, params.alpha, params.beta, robust_beta, dtype=params.dtype)

    out = []
    for y, n in ((wins[0], wins[1]), (wins[2], wins[3])):
        e = torch.stack([table(y[w], n[w]) for w in range(n_win)])
        out.append(torch.where(pad, 0.0, e).contiguous())
    return out


def expected_launches(boundary, segment_size, buffer_size, blocks_per_window, chunks, reruns=0):
    """Resampler launches of one rank's call over ``chunks`` unit chunks:
    halo (seg + 2 buf) - 1 a chunk (site 0 is a cold start); exchange
    (W - 1) + window a chunk (the warm step at site 0 resamples for every
    unit, cold ones included), plus the window again for each of the
    ``reruns`` chunks whose main filter re-runs for round 2 (with two
    chunks or more, those holding a unit left of the last window)."""
    if boundary == "halo":
        return chunks * (segment_size + 2 * buffer_size - 1)
    win = blocks_per_window * segment_size
    W = min(max(1, 2 * buffer_size), win)
    return chunks * ((W - 1) + win) + reruns * win


def _all_gather(t, mesh):
    """Every rank's (U_r, ...) tensor, concatenated in rank order, on t's
    device; with one rank, t itself."""
    if mesh.world == 1:
        return t
    src = t.cpu() if dist.get_backend() == "gloo" else t.contiguous()
    out = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(out, src)
    MESSAGES.calls += 1
    return torch.cat(out).to(t.device)


def _gather_to_root(t, mesh):
    """Every rank's (U_r, ...) host tensor concatenated on rank 0 (None on
    the other ranks)."""
    if mesh.world == 1:
        return t
    src = t if dist.get_backend() == "gloo" else t.to(mesh.device)
    out = [torch.empty_like(src) for _ in range(mesh.world)] if mesh.rank == 0 else None
    dist.gather(src, out, dst=0)
    MESSAGES.calls += 1
    return torch.cat(out).cpu() if mesh.rank == 0 else None


def _chunks(units, per_unit_bytes, device, max_units_per_call):
    cap = max(1, int(memory_budget_bytes(device) // per_unit_bytes))
    if max_units_per_call is not None:
        cap = min(cap, max(1, int(max_units_per_call)))
    return [units[i : i + cap] for i in range(0, len(units), cap)]


def sharded_two_group_inference(
    mesh,
    params,
    n_meth_control,
    n_total_control,
    n_meth_case,
    n_total_case,
    *,
    segment_size,
    buffer_size,
    num_resampled_ancestors,
    num_samples_backward,
    seeds,
    base_key=0,
    weight_dtype=torch.float32,
    boundary="halo",
    phantom_regime=None,
    robust_beta=None,
    max_units_per_call=None,
    timings=None,
    sites_per_graph=SITES_PER_GRAPH,
):
    """Run the whole chromosome's units over the mesh.

    Returns (trajectories, log_z) on rank 0, numpy, the JAX function's
    shapes; None on the other ranks:
      trajectories: (n_blocks * segment_size, n_seeds * B, 5) int32,
        halo-trimmed and genome-ordered (rows past the chromosome's T are
        padding; slice [:T]);
      log_z: (n_blocks, n_seeds) halo, (n_genome, n_seeds) exchange, as
        float64 holding the weight dtype's values.

    robust_beta, when given, swaps the BetaBinomial emissions for the
    beta-divergence score of that exponent. max_units_per_call caps a
    chunk's units below the memory budget's cap. ``timings``, a dict, gets
    the seconds of the tables, the filter sweeps, the backward sweeps and
    the messages ("tables_s", "filter_s", "backward_s", "messages_s"), the
    rank's chunk sizes ("chunks") and, on rank 0, the degenerate filter
    steps per unit ("degenerate", log_z's shape). ``sites_per_graph``: the
    site loops' sites a CUDA graph on the card (0: eagerly, only to compare
    the two)."""
    if boundary not in ("halo", "exchange"):
        raise ValueError(f"unknown boundary scheme: {boundary!r}")
    if mesh.world > 1 and not dist.is_initialized():
        raise RuntimeError(f"a mesh over {mesh.world} ranks needs torch.distributed initialised "
                           "(parallel/launcher.initialize_distributed)")
    n_genome, n_seed_mesh = mesh.shape
    seeds = list(seeds)
    n_seeds = len(seeds)
    if n_seeds % n_seed_mesh:
        raise ValueError("len(seeds) must be a multiple of the seed mesh axis")
    T = n_meth_control.shape[0]
    n_blocks = max(1, -(-T // segment_size))
    n_blocks = -(-n_blocks // n_genome) * n_genome
    bpd, spd = n_blocks // n_genome, n_seeds // n_seed_mesh
    M, B = num_resampled_ancestors, num_samples_backward
    N = M * num_children(params.n_regimes)
    dev = params.device
    tim = {"tables_s": 0.0, "filter_s": 0.0, "backward_s": 0.0, "messages_s": 0.0, "chunks": []}
    MESSAGES.reset()
    counts = (n_meth_control, n_total_control, n_meth_case, n_total_case)

    # The global unit order: shards in genome-major order, then their units;
    # a rank's units are a contiguous run of it.
    def shard_units(g, q):
        s_idx = range(q * spd, (q + 1) * spd)
        if boundary == "halo":
            return [(b, s) for b in range(g * bpd, (g + 1) * bpd) for s in s_idx]
        return [(g, s) for s in s_idx]

    all_units = [u for r in range(mesh.world) for g, q in mesh.shards(r) for u in shard_units(g, q)]
    mine = [u for g, q in mesh.shards() for u in shard_units(g, q)]

    t0 = time.perf_counter()
    if boundary == "halo":
        E_c, E_k = window_tables(params, counts, T, segment_size, buffer_size, n_blocks, robust_beta)
        win = segment_size + 2 * buffer_size
    else:
        win = bpd * segment_size
        E_c, E_k = window_tables(params, counts, T, win, None, n_genome, robust_beta)
    _sync(dev)
    tim["tables_s"] = time.perf_counter() - t0

    per_unit = bytes_per_seed(win, N, B)
    if boundary == "exchange":
        budget = memory_budget_bytes(dev)
        if per_unit > budget:
            raise MemoryError(
                f"an exchange window of {win} sites holds {per_unit} bytes a unit on the device, more "
                f"than the budget of {int(budget)} bytes: use more genome shards (--mesh GxS with a "
                "larger G) so that each window is shorter")
    chunks = _chunks(mine, per_unit, dev, max_units_per_call)
    tim["chunks"] = [len(c) for c in chunks]
    if boundary == "halo":
        traj, log_z, degen = _run_halo(params, E_c, E_k, chunks, seeds, segment_size, buffer_size, M, B, base_key,
                                       weight_dtype, phantom_regime, tim, sites_per_graph)
    else:
        traj, log_z, degen = _run_exchange(mesh, params, E_c, E_k, chunks, all_units, seeds, buffer_size, M, B,
                                           base_key, bpd, weight_dtype, phantom_regime, tim, sites_per_graph)

    # Results to rank 0: trajectories, then logZ and the degenerate counts
    # as one float64 tensor (both exact in it).
    t0 = time.perf_counter()
    traj = _gather_to_root(torch.from_numpy(traj), mesh)
    stats = _gather_to_root(torch.stack([log_z.double(), degen.double()], dim=1), mesh)
    MESSAGES.rounds += 2
    tim["messages_s"] += time.perf_counter() - t0
    if timings is not None:
        timings.update(tim)
    if mesh.rank != 0:
        return None
    traj, stats = traj.numpy(), stats.numpy()
    rows = traj.shape[1]
    out = np.empty((n_blocks * segment_size, n_seeds * B, 5), np.int32)
    n_rows_lz = n_blocks if boundary == "halo" else n_genome
    lz = np.empty((n_rows_lz, n_seeds), np.float64)
    dg = np.empty((n_rows_lz, n_seeds), np.int64)
    for i, (w, s) in enumerate(all_units):
        out[w * rows : (w + 1) * rows, s * B : (s + 1) * B] = traj[i]
        lz[w, s], dg[w, s] = stats[i]
    if timings is not None:
        timings["degenerate"] = dg
    return out, lz


def _run_halo(params, E_c, E_k, chunks, seeds, seg, buf, M, B, base_key, weight_dtype, phantom_regime, tim, K):
    """Each chunk's (block, seed) units: filter, backward simulation, halo
    trimmed on the device. Returns the rank's (trajectories (U_r, seg, B, 5)
    int32 numpy, logZ (U_r,), degenerate steps (U_r,))."""
    dev = params.device
    trajs, log_zs, degens = [], [], []
    for chunk in chunks:
        idx = torch.as_tensor([b for b, _ in chunk], device=dev)
        gens_f = [unit_generator(dev, FILTER, base_key, b, seeds[s]) for b, s in chunk]
        gens_b = [unit_generator(dev, BACKWARD, base_key, b, seeds[s]) for b, s in chunk]
        t0 = time.perf_counter()
        res = run_filter(params, E_c.index_select(0, idx), E_k.index_select(0, idx), M, n_units=len(chunk),
                         generator=gens_f, weight_dtype=weight_dtype, phantom_regime=phantom_regime,
                         sites_per_graph=K)
        _sync(dev)
        t1 = time.perf_counter()
        traj = backward_simulation(params, res.log_weights, res.particles, B, generator=gens_b, sites_per_graph=K)
        trajs.append(traj[:, buf : buf + seg].cpu().numpy())
        log_zs.append(res.log_normalizing_constant.cpu())
        degens.append(res.degenerate_steps.cpu())
        del res, traj
        t2 = time.perf_counter()
        tim["filter_s"] += t1 - t0
        tim["backward_s"] += t2 - t1
    return np.concatenate(trajs), torch.cat(log_zs), torch.cat(degens)


def _run_exchange(mesh, params, E_c, E_k, chunks, all_units, seeds, buf, M, B, base_key, bpd, weight_dtype,
                  phantom_regime, tim, K):
    """The four exchange phases over the rank's (window, seed) units, chunk
    by chunk; the messages between the phases. With one chunk the main
    filter's history is kept for round 2; with more it is freed after round
    1 and the main filter re-runs from its generators' saved states (the
    same realisation). Returns what ``_run_halo`` returns, whole windows."""
    dev = params.device
    n_genome = mesh.n_genome
    win = E_c.shape[1]
    W = min(max(1, 2 * buf), win)
    gidx = {u: i for i, u in enumerate(all_units)}
    units = [u for c in chunks for u in c]

    def gens(stream, chunk):
        return [unit_generator(dev, stream, base_key, g * bpd, seeds[s]) for g, s in chunk]

    def rows(chunk):
        return torch.as_tensor([g for g, _ in chunk], device=dev)

    def shift(local, step):
        """Each unit's (g + step, s) neighbour's row of ``local`` (itself at
        the mesh's edge, where the message is unused)."""
        t0 = time.perf_counter()
        full = _all_gather(local, mesh)
        src = [gidx[(g + step, s)] if 0 <= g + step < n_genome else gidx[(g, s)] for g, s in units]
        out = full.index_select(0, torch.as_tensor(src, device=dev))
        _sync(dev)
        MESSAGES.rounds += 1
        tim["messages_s"] += time.perf_counter() - t0
        return out

    # 1. Warmup over each window's last W sites -> its final state, right.
    t0 = time.perf_counter()
    warm_lw, warm_parts, warm_degen = [], [], []
    for chunk in chunks:
        r = rows(chunk)
        res = run_filter(params, E_c.index_select(0, r)[:, win - W :], E_k.index_select(0, r)[:, win - W :], M,
                         n_units=len(chunk), generator=gens(WARMUP, chunk), weight_dtype=weight_dtype,
                         phantom_regime=phantom_regime, return_history=False, sites_per_graph=K)
        warm_lw.append(res.log_weights)
        warm_parts.append(torch.stack(res.particles, dim=1))
        warm_degen.append(res.degenerate_steps)
    _sync(dev)
    tim["filter_s"] += time.perf_counter() - t0
    recv_lw = shift(torch.cat(warm_lw), -1)
    recv_parts = shift(torch.cat(warm_parts), -1)

    # 2-3. Warm-started main filter and backward round 1 -> first-site
    # states, left.
    keep = len(chunks) == 1
    saved, kept, firsts, last_traj, log_zs, degens = [], [], [], {}, [], []
    lo = 0
    for chunk in chunks:
        sl = slice(lo, lo + len(chunk))
        lo += len(chunk)
        g_main = gens(FILTER, chunk)
        saved.append([g.get_state() for g in g_main])
        t0 = time.perf_counter()
        res = _main_filter(params, E_c, E_k, chunk, rows(chunk), M, g_main, recv_lw[sl], recv_parts[sl],
                           weight_dtype, phantom_regime, K)
        _sync(dev)
        t1 = time.perf_counter()
        traj1 = backward_simulation(params, res.log_weights, res.particles, B, generator=gens(BACKWARD, chunk),
                                    sites_per_graph=K)
        firsts.append(traj1[:, 0])
        for i, (g, s) in enumerate(chunk):
            if g == n_genome - 1:  # the last shard keeps round 1's draws
                last_traj[(g, s)] = traj1[i].cpu().numpy()
        log_zs.append(res.log_normalizing_constant.cpu())
        degens.append(res.degenerate_steps.cpu())
        if keep:
            kept.append(res)
        del res, traj1
        _sync(dev)
        tim["filter_s"] += t1 - t0
        tim["backward_s"] += time.perf_counter() - t1
    recv_t = shift(torch.cat(firsts), +1)

    # 4. Round 2, conditioned on the right neighbour's first-site states.
    trajs = []
    lo = 0
    for c, chunk in enumerate(chunks):
        sl = slice(lo, lo + len(chunk))
        lo += len(chunk)
        use_term = [g < n_genome - 1 for g, _ in chunk]
        if not any(use_term):
            trajs.append(np.stack([last_traj[u] for u in chunk]))
            continue
        t0 = time.perf_counter()
        if keep:
            res = kept.pop()
        else:
            g_main = gens(FILTER, chunk)
            for g, st in zip(g_main, saved[c]):
                g.set_state(st)
            res = _main_filter(params, E_c, E_k, chunk, rows(chunk), M, g_main, recv_lw[sl], recv_parts[sl],
                               weight_dtype, phantom_regime, K)
            _sync(dev)
        t1 = time.perf_counter()
        traj = backward_simulation_conditioned(
            params, res.log_weights, res.particles, recv_t[sl],
            torch.as_tensor(use_term, device=dev), generator=gens(BACKWARD2, chunk), sites_per_graph=K)
        del res
        traj = traj.cpu().numpy()
        for i, u in enumerate(chunk):
            if not use_term[i]:
                traj[i] = last_traj[u]
        trajs.append(traj)
        tim["filter_s"] += t1 - t0
        tim["backward_s"] += time.perf_counter() - t1
    degen = torch.cat(degens) + torch.cat(warm_degen).cpu()
    return np.concatenate(trajs), torch.cat(log_zs), degen


def _main_filter(params, E_c, E_k, chunk, rows, M, generators, init_lw, init_parts, weight_dtype,
                 phantom_regime, K):
    """The exchange scheme's main filter over a chunk's windows: warm from
    the received state, cold on shard 0."""
    return run_filter(params, E_c.index_select(0, rows), E_k.index_select(0, rows), M, n_units=len(chunk),
                      generator=generators, weight_dtype=weight_dtype, phantom_regime=phantom_regime,
                      init_state=(init_lw, init_parts), use_init=[g > 0 for g, _ in chunk], sites_per_graph=K)
