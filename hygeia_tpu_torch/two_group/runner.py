"""The ``infer`` verb: windowing, filter, backward simulation,
reference-format outputs.

Counterpart of hygeia_tpu/two_group/runner.py (``segment_window``,
``infer_segment``, ``infer_chromosome_streamed``,
``infer_chromosome_meshed``: parallel/sharded.py over a mesh of ranks). On the monolithic path
the whole (T, N) history of a chunk of seeds is held on the device, then
consumed by the backward pass; with ``streaming_blocks=W`` the chunk runs
through two_group/streaming.py, which holds one W-site block. The seeds of
a chunk run together as the leading unit axis U. Output files, names and
dtypes are the JAX runner's. The three entry points share one input stage
(``_read_inputs``) and one writer for each kind of file
(``_write_observations``, ``_write_unit_outputs``, ``_write_seed_files``).

``infer_segment``'s phases are spans (utils/spans.py): the call
``infer.call`` (chrom, batch, units, sites) and, inside it, ``infer.read``
(theta, positions and counts, the slice and the count check),
``infer.tables`` (the model's parameters and the emission tables; it waits
for the device at its end while the recorder is on), ``infer.write`` (the
observation files, the unit archives, the seed files) and, on the
monolithic path, ``infer.filter``, ``infer.backward`` (with the
functionals) and ``infer.fetch`` (the copies to the host).

``trace_dir`` profiles each call with ``torch.profiler`` (CPU activity,
and CUDA activity on the card) and writes one Chrome-format trace a call
there (``tensorboard_trace_handler``; the JAX runner writes its profiler's
TensorBoard profile), in which the spans show as ranges of their names.
Tracing changes no output.
"""

from __future__ import annotations

import contextlib
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from hygeia_tpu_torch.ops.emissions import emission_log_prob_table, robust_emission_log_prob_table
from hygeia_tpu_torch.ops.site_graphs import SITES_PER_GRAPH, _sync
from hygeia_tpu_torch.two_group.backward import backward_simulation, smoothing_functionals
from hygeia_tpu_torch.two_group.filter import HISTORY_BYTES_PER_PARTICLE_SITE, run_filter
from hygeia_tpu_torch.two_group.model import make_params
from hygeia_tpu_torch.two_group.streaming import block_bounds, streamed_inference
from hygeia_tpu_torch.utils import io as hio
from hygeia_tpu_torch.utils import spans

DEFAULT_MU = (0.95, 0.05, 0.80, 0.20, 0.50, 0.50)
DEFAULT_SIGMA = (0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751)

# Device bytes per seed besides the history: the (T, B, 5) int32
# trajectories, plus per-step scratch of the filter (~512 B a particle) and
# of the backward pass (~160 B a particle and trajectory).
_TRAJ_BYTES_PER_SITE_SAMPLE = 5 * 4
_CPU_BUDGET_BYTES = 4 * 2**30


def segment_window(n_positions, batch, segment_size, buffer_size):
    """(slice_range, return_range) for a batch; None if the batch index is
    out of range."""
    if batch * segment_size > n_positions:
        return None
    lo = max(0, batch * segment_size - buffer_size)
    hi = min((batch + 1) * segment_size + buffer_size, n_positions)
    n_slice = hi - lo
    if batch == 0:
        ret = range(0, min(n_slice, segment_size))
    else:
        ret = range(buffer_size, min(n_slice, buffer_size + segment_size))
    return range(lo, hi), ret


def memory_budget_bytes(device) -> float:
    """Bytes a chunk of seeds may use: HYGEIA_HBM_BUDGET_GB when set, else
    90% of the device's free memory (torch.cuda.mem_get_info); on the CPU
    (the tests) a fixed 4 GiB."""
    env = os.environ.get("HYGEIA_HBM_BUDGET_GB")
    if env:
        return float(env) * 2**30
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return 0.9 * free
    return float(_CPU_BUDGET_BYTES)


def bytes_per_seed(T, N, B) -> int:
    history = T * N * HISTORY_BYTES_PER_PARTICLE_SITE
    traj = T * B * _TRAJ_BYTES_PER_SITE_SAMPLE
    scratch = N * (512 + 160 * B)
    return history + traj + scratch


def bytes_per_streamed_unit(T, W, N, B) -> int:
    """Device bytes of one unit of a streamed call: one block as the
    monolithic path holds a segment (JAX's min(T, W) rule), plus the
    checkpoints, a (U, N) f32 weight row and (U, 5, N) int32 particles a
    block."""
    n_blocks = len(block_bounds(T, W))
    return bytes_per_seed(min(T, W), N, B) + n_blocks * N * 24


def _generator(device, seeds, stream):
    """A generator for a chunk of seeds: the filter's (stream 0) or the
    backward pass's (stream 1). A seed run alone always gets the same
    stream; realisations differ from the JAX package's (threefry keys)."""
    g = torch.Generator(device=device)
    ss = np.random.SeedSequence([int(stream), *map(int, seeds)])
    g.manual_seed(int(ss.generate_state(1, np.uint32)[0]))
    return g


def _profile(trace_dir, device):
    """A torch.profiler context writing one trace into ``trace_dir`` when it
    exits (CPU activity, plus CUDA activity on a CUDA device), or a null
    context when no ``trace_dir`` is given."""
    if not trace_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(trace_dir)))


def _make_params(mu, sigma, p_softmax, omega_logit_control, omega_case, merge_log_prob,
                 split_prob, minimum_duration, d_max, device):
    R = len(mu)
    return make_params(
        mu=mu,
        sigma=sigma,
        p_softmax_control=p_softmax,
        omega_logit_control=omega_logit_control,
        omega_case=omega_case,
        kappa_control=np.full(R, 2.0),
        kappa_case=np.full(R, 2.0),
        merge_log_prob=merge_log_prob,
        split_prob=split_prob,
        minimum_duration=minimum_duration,
        d_max=d_max,
        device=device,
    )


def _emission_tables(n_meth_control, n_total_control, n_meth_case, n_total_case, params, robust,
                     robust_beta):
    """The (T, R) control and case emission tables on the parameters'
    device: BetaBinomial log-likelihoods, or with ``robust`` the
    beta-divergence score of exponent ``robust_beta``."""
    if robust:
        def table(y, n):
            return robust_emission_log_prob_table(y, n, params.alpha, params.beta, robust_beta)
    else:
        def table(y, n):
            return emission_log_prob_table(y, n, params.alpha, params.beta)
    return table(n_meth_control, n_total_control), table(n_meth_case, n_total_case)


def _read_inputs(data_dir, single_group_dir, chrom, R, segment=None):
    """The INFER inputs of ``chrom``: (p_softmax, omega_logit_control,
    positions, counts, window), counts the four (T, S) tables
    (n_meth_control, n_total_control, n_meth_case, n_total_case).

    With ``segment`` = (batch, segment_size, buffer_size) the rows are the
    batch's window and ``window`` its (rows, return rows) as slices; a
    batch past the end gives None, before any count is read. Without it the
    rows are the whole chromosome and ``window`` is None. Raises where a
    methylated count exceeds its total in the rows."""
    theta = hio.read_theta(os.path.join(single_group_dir, f"theta_{chrom}.csv.gz"))
    p_softmax, omega_logit_control = hio.theta_file_to_p_softmax(theta, R)
    positions = hio.read_positions(os.path.join(data_dir, f"positions_{chrom}.txt.gz"))
    rows, window = slice(None), None
    if segment is not None:
        window = segment_window(len(positions), *segment)
        if window is None:
            return None
        window = tuple(slice(r.start, r.stop) for r in window)
        rows = window[0]

    def load(name):
        return hio.read_count_matrix(os.path.join(data_dir, f"{name}_{chrom}.txt.gz"))[rows]

    n_total_control = load("n_total_reads_control")
    n_meth_control = load("n_methylated_reads_control")
    n_total_case = load("n_total_reads_case")
    n_meth_case = load("n_methylated_reads_case")
    if np.any(n_total_case < n_meth_case) or np.any(n_total_control < n_meth_control):
        raise ValueError("methylated read counts exceed total read counts")
    return (p_softmax, omega_logit_control, positions[rows],
            (n_meth_control, n_total_control, n_meth_case, n_total_case), window)


def _write_observations(path, counts, positions, rows, submit=None):
    """The five observation tables of ``rows`` of counts (as _read_inputs
    gives them) and positions, into ``path``: written here, or handed to
    ``submit`` (a pool's), whose futures come back."""
    n_meth_control, n_total_control, n_meth_case, n_total_case = counts
    write = submit or (lambda fn, *a: fn(*a))
    return [write(hio.write_count_matrix, os.path.join(path, f"{name}.csv.gz"), arr) for name, arr in (
        ("observations_control", n_meth_control[rows].astype(np.int16)),
        ("observations_case", n_meth_case[rows].astype(np.int16)),
        ("n_total_reads_control", n_total_control[rows].astype(np.int16)),
        ("n_total_reads_case", n_total_case[rows].astype(np.int16)),
        ("positions", positions[rows]),
    )]


def _write_unit_outputs(path, N, s, traj, split, regime, ret, level=0):
    """One unit's trajectory, split and regime archives, the JAX runner's
    names and dtypes; traj (T, B, 5) int32, cut to the return range. The
    trajectories are stored (``level`` 0) or deflated at zlib ``level``."""
    for name, arr in (
        ("merged_state", traj[:, :, 0].astype(np.int16)[ret]),
        ("control_state", traj[:, :, 1:3].astype(np.int32)[ret]),
        ("case_state", traj[:, :, 3:5].astype(np.int32)[ret]),
    ):
        hio.savez_fast(os.path.join(path, f"optimal_backward_particles_{name}_{N}_{s}"), arr, level=level)
    hio.savez_fast(os.path.join(path, f"optimal_split_probs_{N}_{s}"), split)
    hio.savez_fast(os.path.join(path, f"optimal_regime_probs_{N}_{s}"), regime)


def _functionals(traj, R, device):
    """smoothing_functionals of a host (U, T, B, 5) int32 trajectory batch,
    on ``device`` at the monolithic path's shapes: its values bit for bit
    (a CUDA mean multiplies by a factor that depends on the shape)."""
    split, regime = smoothing_functionals(torch.from_numpy(traj).to(device), R)
    return split.cpu().numpy(), regime.cpu().numpy()


def _functionals_numpy(traj, R):
    """The split and regime probabilities of one unit's host (T, B, 5)
    trajectories in numpy, the JAX meshed path's arithmetic, which the
    meshed path keeps: ``_functionals`` takes the device's reductions, and
    a CUDA mean multiplies by a reciprocal, which can move a last bit."""
    split = (traj[:, :, 0] == 0).mean(axis=1).astype(np.float32)
    regime = np.concatenate(
        [np.stack([(traj[:, :, 2] == r).mean(axis=1) for r in range(R)], -1),
         np.stack([(traj[:, :, 4] == r).mean(axis=1) for r in range(R)], -1)],
        axis=-1,
    ).astype(np.float32)
    return split, regime


def _flags(chrom, batch, segment_size, buffer_size, mu, sigma, minimum_duration, omega_case,
           merge_log_prob, split_prob, num_resampled_particles, num_samples_backward,
           multinomial, robust, marginal, streaming_blocks):
    return {
        "chrom": str(chrom), "batch": batch, "segment_size": segment_size,
        "buffer_size": buffer_size, "mu": list(map(float, mu)),
        "sigma": list(map(float, np.asarray(sigma, np.float64))),
        "minimum_duration": minimum_duration, "omega_case": omega_case,
        "merge_log_prob": float(merge_log_prob), "split_prob": split_prob,
        "num_resampled_particles": list(num_resampled_particles),
        "num_samples_backward": num_samples_backward,
        "multinomial": multinomial, "robust": robust, "marginal": marginal,
        "streaming_blocks": streaming_blocks,
    }


def _write_seed_files(path, flags, s, log_norm, times, times_backward):
    with open(os.path.join(path, f"flags{s}.txt"), "w") as f:
        for k, v in {**flags, "seed": s}.items():
            print(f"--{k}={v}", file=f)
    with open(os.path.join(path, f"log_normalizing_constants_optimal_{s}.txt"), "w") as f:
        print(log_norm, file=f)
    with open(os.path.join(path, f"optimal_time_{s}.txt"), "w") as f:
        print(times, file=f)
    with open(os.path.join(path, f"optimal_time_backward_{s}.txt"), "w") as f:
        print(times_backward, file=f)


def _run_marginal_m(path, seeds, seeds_per_call, params, E_c, E_k, M, N, ret, epsilon, window,
                    all_log_norm, times, device, sites_per_graph):
    """The marginal filter for one particle budget M, chunk by chunk of
    seeds: one site loop a chunk; writes each seed's split and regime
    probabilities (the npz names and shapes of the backward-simulation
    path) and records its logZ and wall share."""
    from hygeia_tpu_torch.two_group.marginal import run_marginal_filter

    for c0 in range(0, len(seeds), seeds_per_call):
        chunk = seeds[c0 : c0 + seeds_per_call]
        _sync(device)
        t0 = time.perf_counter()
        res = run_marginal_filter(params, E_c, E_k, M, n_units=len(chunk),
                                  generator=_generator(device, chunk, 0), epsilon=epsilon,
                                  smoothing_window=window, sites_per_graph=sites_per_graph)
        fn = res.functionals.cpu().numpy()
        log_z, spill = res.log_normalizing_constant.cpu().numpy(), res.spill_count.cpu().numpy()
        degen = res.degenerate_steps.cpu().numpy()
        elapsed = time.perf_counter() - t0
        with spans.span("infer.write"):
            for i, s in enumerate(chunk):
                _report_degenerate(f"seed {s}", degen[i])
                times[s][N] = elapsed / len(chunk)
                all_log_norm[s][N] = float(log_z[i])
                hio.savez_fast(os.path.join(path, f"optimal_split_probs_{N}_{s}"), fn[i, ret, 0])
                hio.savez_fast(os.path.join(path, f"optimal_regime_probs_{N}_{s}"), fn[i, ret, 1:])
                print(f"marginal filter seed {s}: spill_count={int(spill[i])}"
                      + (" (pending times force-finalised: smoothing window spill)" if spill[i] else ""))


def _report_degenerate(label, d):
    if d:
        # Nonzero means the whole particle set collapsed at some sites.
        print(f"WARNING: {label}: {int(d)} degenerate filter steps")
    else:
        print(f"{label}: degenerate_steps=0")


def _infer_chunk(params, E_c, E_k, M, B, R, chunk, device, streaming_blocks, timings, K):
    """Filter and backward simulation of one chunk of seeds as U units:
    (logZ (U,), trajectories (U, T, B, 5), split (U, T), regime (U, T, 2R),
    degenerate steps (U,), filter and backward seconds a seed), as numpy."""
    _sync(device)
    t0 = time.perf_counter()
    if streaming_blocks:
        tim = None if timings is None else {}
        traj, log_z, degen = streamed_inference(
            params, E_c, E_k, M, B, n_units=len(chunk),
            generator=_generator(device, chunk, 0),
            backward_generator=_generator(device, chunk, 1),
            block_size=int(streaming_blocks), timings=tim, sites_per_graph=K,
        )
        if timings is not None:
            for k, v in tim.items():
                timings.setdefault(k, []).append(v)
        log_z, degen = log_z.cpu().numpy(), degen.cpu().numpy()
        split, regime = _functionals(traj, R, device)
        # One wall for both sweeps; the backward file records 0, as the JAX
        # runner's streamed path does.
        return log_z, traj, split, regime, degen, (time.perf_counter() - t0) / len(chunk), 0.0
    with spans.span("infer.filter"):
        res = run_filter(params, E_c, E_k, M, n_units=len(chunk), generator=_generator(device, chunk, 0),
                         sites_per_graph=K)
        _sync(device)
    t1 = time.perf_counter()
    with spans.span("infer.backward"):
        traj = backward_simulation(params, res.log_weights, res.particles, B,
                                   generator=_generator(device, chunk, 1), sites_per_graph=K)
        split, regime = smoothing_functionals(traj, R)
        _sync(device)
    t2 = time.perf_counter()
    with spans.span("infer.fetch"):
        log_z = res.log_normalizing_constant.cpu().numpy()
        degen = res.degenerate_steps.cpu().numpy()
        del res  # frees the chunk's (U, T, N) history
        traj, split, regime = traj.cpu().numpy(), split.cpu().numpy(), regime.cpu().numpy()
    return log_z, traj, split, regime, degen, (t1 - t0) / len(chunk), (t2 - t1) / len(chunk)


def infer_segment(
    *,
    data_dir,
    single_group_dir,
    results_dir,
    chrom,
    device,
    batch=0,
    seed=0,
    segment_size=100000,
    buffer_size=5000,
    mu=DEFAULT_MU,
    sigma=DEFAULT_SIGMA,
    minimum_duration=3,
    omega_case=0.8,
    merge_log_prob=np.log(0.1),
    split_prob=0.01,
    num_resampled_particles=(50,),
    num_samples_backward=25,
    multinomial=False,
    robust=False,
    robust_beta=0.05,
    trace_dir=None,
    marginal=False,
    max_seeds_per_call=None,
    streaming_blocks=None,
    timings=None,
    marginal_epsilon=0.01,
    marginal_window=64,
    sites_per_graph=SITES_PER_GRAPH,
):
    """Run inference for one (chrom, batch, seed or seeds) work unit on
    ``device`` and write the reference-format outputs under
    results_dir/chrom_{chrom}_{batch}/. Returns logZ ({N: logZ}, or a dict
    of those per seed when several seeds are given). Weights are f32.

    streaming_blocks=W runs each chunk of seeds through
    ``streaming.streamed_inference`` in W-site blocks: the same
    trajectories, split and regime probabilities as the monolithic path for
    the same chunk, bit for bit, with one block's history on the device.
    ``timings``, a dict, then collects streamed_inference's per-block walls
    (one list entry per chunk).

    robust=True swaps the BetaBinomial emissions for the beta-divergence
    score of exponent ``robust_beta``. max_seeds_per_call caps the seeds of
    a chunk on top of the memory budget's cap: the pipeline lowers it on
    each retry of a failed unit.

    marginal=True runs the adaptive-lag marginal filter
    (two_group/marginal.py) in place of the filter and backward
    simulation, and takes precedence over streaming_blocks: it writes the
    split and regime probabilities (optimal_split_probs_{N}_{s},
    optimal_regime_probs_{N}_{s}), no trajectories, with marginal_epsilon
    and marginal_window (pending times a unit holds).

    trace_dir: a ``torch.profiler`` trace of the call is written there, in
    every mode (monolithic, streamed, robust, marginal).

    multinomial is recorded in the flags files only: as in hygeia_tpu, the
    INFER filter always takes the optimal resampler (whose fallback is
    multinomial).

    sites_per_graph: the site loops' sites a CUDA graph on the card (the
    filter's, the backward pass's or the marginal filter's; 0: eagerly,
    only to compare the two; the same files either way)."""
    device = torch.device(device)
    mu = np.asarray(mu, np.float64)
    R = len(mu)
    seeds = [seed] if np.isscalar(seed) else list(seed)
    with _profile(trace_dir, device), spans.span("infer.call", chrom=str(chrom), batch=batch, units=len(seeds)):
        with spans.span("infer.read"):
            inputs = _read_inputs(data_dir, single_group_dir, chrom, R, (batch, segment_size, buffer_size))
            if inputs is None:
                print("Batch index is too large for the chromosome")
                return None
            p_softmax, omega_logit_control, positions, counts, (_, ret) = inputs
        T = counts[0].shape[0]
        spans.annotate(sites=T)

        path = os.path.join(results_dir, f"chrom_{chrom}_{batch}")
        os.makedirs(path, exist_ok=True)
        with spans.span("infer.write"):
            _write_observations(path, counts, positions, ret)

        with spans.span("infer.tables", sync=device):
            params = _make_params(mu, sigma, p_softmax, omega_logit_control, omega_case, merge_log_prob,
                                  split_prob, minimum_duration, max(64, T + 1), device)
            E_c, E_k = _emission_tables(*counts, params, robust, robust_beta)

        all_log_norm = {s: {} for s in seeds}
        times = {s: {} for s in seeds}
        times_backward = {s: {} for s in seeds}
        budget = memory_budget_bytes(device)
        B = num_samples_backward

        for M in num_resampled_particles:
            N = M * (2 * R + R * R)
            if marginal:
                per_seed = N * N * 8  # the JAX runner's rule for the marginal filter
            elif streaming_blocks:
                per_seed = bytes_per_streamed_unit(T, int(streaming_blocks), N, B)
            else:
                per_seed = bytes_per_seed(T, N, B)
            seeds_per_call = max(1, int(budget // per_seed))
            if max_seeds_per_call is not None:
                seeds_per_call = min(seeds_per_call, max(1, int(max_seeds_per_call)))
            if marginal:
                _run_marginal_m(path, seeds, seeds_per_call, params, E_c, E_k, M, N, ret, marginal_epsilon,
                                marginal_window, all_log_norm, times, device, sites_per_graph)
                continue

            outs = {}
            for c0 in range(0, len(seeds), seeds_per_call):
                chunk = seeds[c0 : c0 + seeds_per_call]
                log_z, traj, split, regime, degen, t_f, t_b = _infer_chunk(
                    params, E_c, E_k, M, B, R, chunk, device, streaming_blocks, timings, sites_per_graph)
                for i, s in enumerate(chunk):
                    _report_degenerate(f"seed {s}", degen[i])
                    outs[s] = (float(log_z[i]), traj[i], split[i], regime[i], t_f, t_b)
            with spans.span("infer.write"):
                for s in seeds:
                    log_z, traj, split_s, regime_s, t_f, t_b = outs[s]
                    all_log_norm[s][N] = log_z
                    times[s][N] = t_f
                    times_backward[s][N] = t_b
                    _write_unit_outputs(path, N, s, traj, split_s, regime_s, ret)

        with spans.span("infer.write"):
            flags = _flags(chrom, batch, segment_size, buffer_size, mu, sigma, minimum_duration, omega_case,
                           merge_log_prob, split_prob, num_resampled_particles, num_samples_backward,
                           multinomial, robust, marginal, streaming_blocks)
            for s in seeds:
                _write_seed_files(path, flags, s, all_log_norm[s], times[s], times_backward[s])
        return all_log_norm if len(seeds) > 1 else all_log_norm[seeds[0]]


def infer_chromosome_streamed(
    *,
    data_dir,
    single_group_dir,
    results_dir,
    chrom,
    device,
    seed=(0,),
    segment_size=100000,
    buffer_size=5000,
    mu=DEFAULT_MU,
    sigma=DEFAULT_SIGMA,
    minimum_duration=3,
    omega_case=0.8,
    merge_log_prob=np.log(0.1),
    split_prob=0.01,
    num_resampled_particles=(50,),
    num_samples_backward=25,
    multinomial=False,
    robust=False,
    robust_beta=0.05,
    streaming_blocks=16384,
    max_units_per_call=None,
    timings=None,
):
    """Whole-chromosome INFER through the streamed engine with units
    batched across segments: every (batch, seed) unit whose window has the
    same length runs in the same site loops, one segment per unit
    ((U, T, R) emissions), instead of one ``infer_segment`` call per batch.

    Windows group by length (the first batch lacks the left halo, the last
    is the remainder). Each group has its own hazard depth
    d_max = max(64, T_w + 1), as ``infer_segment`` gives it, and its units
    are chunked by its own memory cap (and max_units_per_call). A chunk's
    generators are seeded from its units' seeds, so with
    max_units_per_call=1 the files are ``infer_segment(streaming_blocks=W)``'s
    for each (batch, seed), bit for bit, except the optimal_time_* files.
    The per-unit file writes run on a two-thread pool, overlapping the next
    chunk's device work. ``timings``, a dict, gets "chunks": one entry per
    chunk, (window length, units, seconds, streamed_inference's per-block
    walls). robust=True builds each unit's rows from the beta-divergence
    score, as ``infer_segment`` does. Returns {batch: {seed: {N: logZ}}}."""
    device = torch.device(device)
    mu = np.asarray(mu, np.float64)
    R = len(mu)
    p_softmax, omega_logit_control, positions_all, counts_all, _ = _read_inputs(
        data_dir, single_group_dir, chrom, R)

    seeds = [seed] if np.isscalar(seed) else list(seed)
    B = num_samples_backward
    W = int(streaming_blocks)
    n_batches = 1 + len(positions_all) // segment_size
    budget = memory_budget_bytes(device)

    pool = ThreadPoolExecutor(max_workers=2)
    futures = []
    post_prev = []  # the previous chunk's writes: at most two chunks in host memory
    try:
        # Per-batch windows and input CSVs (infer_segment's), the writes on
        # the pool.
        wins = {}
        for batch in range(n_batches):
            window = segment_window(len(positions_all), batch, segment_size, buffer_size)
            if window is None:
                continue
            sl, ret = (slice(r.start, r.stop) for r in window)
            counts = tuple(c[sl] for c in counts_all)
            path = os.path.join(results_dir, f"chrom_{chrom}_{batch}")
            os.makedirs(path, exist_ok=True)
            futures += _write_observations(path, counts, positions_all[sl], ret, pool.submit)
            wins[batch] = (sl.stop - sl.start, ret, counts, path)

        all_log_norm = {b: {s: {} for s in seeds} for b in wins}
        times = {b: {s: {} for s in seeds} for b in wins}
        groups = {}
        for batch, (t_w, _, _, _) in wins.items():
            groups.setdefault(t_w, []).append(batch)

        for M in num_resampled_particles:
            N = M * (2 * R + R * R)
            for t_w, group_batches in sorted(groups.items()):
                params = _make_params(mu, sigma, p_softmax, omega_logit_control, omega_case,
                                      merge_log_prob, split_prob, minimum_duration,
                                      max(64, t_w + 1), device)
                emis = {}
                for b in group_batches:
                    emis[b] = _emission_tables(*wins[b][2], params, robust, robust_beta)
                cap = max(1, int(budget // bytes_per_streamed_unit(t_w, W, N, B)))
                if max_units_per_call is not None:
                    cap = min(cap, int(max_units_per_call))
                units = [(b, s) for b in group_batches for s in seeds]
                for c0 in range(0, len(units), cap):
                    chunk = units[c0 : c0 + cap]
                    chunk_seeds = [s for _, s in chunk]
                    E_c = torch.stack([emis[b][0] for b, _ in chunk])
                    E_k = torch.stack([emis[b][1] for b, _ in chunk])
                    tim = None if timings is None else {}
                    t0 = time.perf_counter()
                    traj, log_z, degen = streamed_inference(
                        params, E_c, E_k, M, B, n_units=len(chunk),
                        generator=_generator(device, chunk_seeds, 0),
                        backward_generator=_generator(device, chunk_seeds, 1),
                        block_size=W, timings=tim,
                    )
                    log_z, degen = log_z.cpu().numpy(), degen.cpu().numpy()
                    t_chunk = time.perf_counter() - t0
                    if timings is not None:
                        timings.setdefault("chunks", []).append((t_w, len(chunk), t_chunk, tim))
                    for i, (b, s) in enumerate(chunk):
                        _report_degenerate(f"batch {b} seed {s}", degen[i])
                        all_log_norm[b][s][N] = float(log_z[i])
                        times[b][s][N] = t_chunk / len(chunk)

                    # Per unit, at infer_segment's one-seed shapes.
                    fun = [_functionals(traj[i : i + 1], R, device) for i in range(len(chunk))]
                    for f in post_prev:
                        f.result()
                    post_prev = [
                        pool.submit(_write_unit_outputs, wins[b][3], N, s, traj[i], fun[i][0][0],
                                    fun[i][1][0], wins[b][1])
                        for i, (b, s) in enumerate(chunk)
                    ]
                    futures.extend(post_prev)
    finally:
        pool.shutdown(wait=True)
    for f in futures:
        f.result()  # surface any writer exception

    for batch, (_, _, _, path) in wins.items():
        flags = _flags(chrom, batch, segment_size, buffer_size, mu, sigma, minimum_duration,
                       omega_case, merge_log_prob, split_prob, num_resampled_particles,
                       num_samples_backward, multinomial, robust, False, streaming_blocks)
        for s in seeds:
            _write_seed_files(path, flags, s, all_log_norm[batch][s], times[batch][s],
                              {n: 0.0 for n in times[batch][s]})
    return all_log_norm


def infer_chromosome_meshed(
    *,
    data_dir,
    single_group_dir,
    results_dir,
    chrom,
    mesh_shape,  # (n_genome, n_seed_mesh)
    device,
    boundary="halo",
    seed=(0, 1),
    segment_size=100000,
    buffer_size=5000,
    mu=DEFAULT_MU,
    sigma=DEFAULT_SIGMA,
    minimum_duration=3,
    omega_case=0.8,
    merge_log_prob=np.log(0.1),
    split_prob=0.01,
    num_resampled_particles=(50,),
    num_samples_backward=25,
    robust=False,
    robust_beta=0.05,
    weight_dtype=torch.float32,
    rng_seed=0,
    max_units_per_call=None,
    timings=None,
    sites_per_graph=SITES_PER_GRAPH,
):
    """Whole-chromosome INFER on a (genome x seed) mesh over the
    ``torch.distributed`` ranks (parallel/sharded.py): every (batch, seed)
    unit of the chromosome runs in one batched site loop a rank and memory
    chunk, instead of one ``infer_segment`` call a batch. Writes
    infer_segment's per-(batch, seed) file set, so AGGREGATE_RESULTS and
    GET_DMPS read it unchanged; only rank 0 writes, and only rank 0 returns
    {seed: {batch: {N: logZ}}} (the other ranks return None).

    As the JAX runner's meshed path: d_max = max(64, T + 1) over the whole
    chromosome (exchange warm starts carry sojourns across windows); the
    split and regime probabilities cover the segment rows only; the flags
    record ``mesh`` and ``boundary``; optimal_time_{s} holds the call's
    wall over the units and optimal_time_backward_{s} {N: 0.0}; in
    exchange mode a batch's logZ file holds its enclosing window's logZ.
    robust=True takes the beta-divergence score of exponent robust_beta.
    Realisations differ from infer_segment's (per-unit generators,
    symmetric zero-padded halos). ``timings``, a dict, gets
    ``sharded_two_group_inference``'s per particle budget N.
    ``sites_per_graph``: as ``infer_segment``'s."""
    from hygeia_tpu_torch.parallel.mesh import make_mesh
    from hygeia_tpu_torch.parallel.sharded import sharded_two_group_inference

    device = torch.device(device)
    mu = np.asarray(mu, np.float64)
    R = len(mu)
    n_genome, n_seed_mesh = mesh_shape
    mesh = make_mesh(n_genome, n_seed_mesh, device=device)

    p_softmax, omega_logit_control, positions, counts, _ = _read_inputs(data_dir, single_group_dir, chrom, R)
    T = len(positions)
    params = _make_params(mu, sigma, p_softmax, omega_logit_control, omega_case, merge_log_prob,
                          split_prob, minimum_duration, max(64, T + 1), device)
    seeds = [seed] if np.isscalar(seed) else list(seed)
    n_batches = 1 + T // segment_size
    B = num_samples_backward
    all_log_norm = {s: {} for s in seeds}
    times = {s: {} for s in seeds}
    primary = mesh.rank == 0

    for M in num_resampled_particles:
        N = M * (2 * R + R * R)
        tim = {}
        _sync(device)
        t0 = time.perf_counter()
        out = sharded_two_group_inference(
            mesh, params, *counts,
            segment_size=segment_size, buffer_size=buffer_size, num_resampled_ancestors=M,
            num_samples_backward=B, seeds=seeds, base_key=rng_seed, weight_dtype=weight_dtype,
            boundary=boundary, robust_beta=robust_beta if robust else None,
            max_units_per_call=max_units_per_call, timings=tim, sites_per_graph=sites_per_graph,
        )
        wall = time.perf_counter() - t0
        if timings is not None:
            timings[N] = {**tim, "wall_s": wall}
        if not primary:
            continue
        traj, log_z = out
        for i, s in enumerate(seeds):
            n_degen = int(tim["degenerate"][:, i].sum())
            _report_degenerate(f"seed {s}", n_degen)
        per_unit = wall / max(1, n_batches * len(seeds))
        bpd = (traj.shape[0] // segment_size) // log_z.shape[0]

        for batch in range(n_batches):
            lo, hi = batch * segment_size, min((batch + 1) * segment_size, T)
            path = os.path.join(results_dir, f"chrom_{chrom}_{batch}")
            os.makedirs(path, exist_ok=True)
            rows = slice(lo, hi)
            _write_observations(path, counts, positions, rows)
            traj_b = traj[rows]  # (hi - lo, n_seeds * B, 5)
            if boundary == "exchange":
                lz_row = log_z[min(batch // max(bpd, 1), log_z.shape[0] - 1)]
            else:
                lz_row = log_z[min(batch, log_z.shape[0] - 1)]
            for i, s in enumerate(seeds):
                tb = traj_b[:, i * B : (i + 1) * B]
                # Trajectories deflated at level 1, as the JAX meshed path's.
                _write_unit_outputs(path, N, s, tb, *_functionals_numpy(tb, R), slice(None), level=1)
                all_log_norm[s].setdefault(batch, {})[N] = float(lz_row[i])
                times[s].setdefault(batch, {})[N] = per_unit

    if not primary:
        return None
    flags = {
        "chrom": str(chrom), "segment_size": segment_size,
        "buffer_size": buffer_size, "mu": list(map(float, mu)),
        "sigma": list(map(float, np.asarray(sigma, np.float64))),
        "minimum_duration": minimum_duration, "omega_case": omega_case,
        "merge_log_prob": float(merge_log_prob), "split_prob": split_prob,
        "num_resampled_particles": list(num_resampled_particles),
        "num_samples_backward": num_samples_backward,
        "robust": robust, "mesh": f"{n_genome}x{n_seed_mesh}",
        "boundary": boundary,
    }
    for batch in range(n_batches):
        path = os.path.join(results_dir, f"chrom_{chrom}_{batch}")
        for s in seeds:
            _write_seed_files(path, {**flags, "batch": batch}, s, all_log_norm[s][batch], times[s][batch],
                              {n: 0.0 for n in times[s][batch]})
    return all_log_norm
