"""Pipeline orchestrator: the ``run`` verb, with and without ``--two_group``.

Counterpart of hygeia_tpu/pipeline/orchestrator.py. The two-group pipeline
runs its six stages over (chromosome x segment x seed) work units in one
process, so the card is taken once; the single-group pipeline
(``run_single_group``) runs its four over (sample x chromosome) units.
Stage completion is recorded with on-disk markers; a re-run skips
completed stages. The output trees are the JAX pipeline's:

  1_PREPROCESS/ 2_ESTIMATE_PARAMETERS_AND_REGIMES/ 3_GET_CHROM_SEGMENTS/
  4_INFER/ 5_AGGREGATE_RESULTS/ 6_GET_DMPS/                (two groups)
  1_PREPROCESS/ 2_ESTIMATE_PARAMETERS/ 3_ESTIMATE_REGIMES/
  4_SINGLE_GROUP_OUTPUT/                                  (single group)

The theta and INFER stages run on ``device`` (the CLI's ``--device``,
default cuda); preprocessing, segments, aggregation and DMP calling are
host numpy work, as in the JAX package. With ``bucket_dir`` the output
tree is mirrored to a store after every completed stage and restored from
it before a resumed run (utils/staging.py). With ``mesh_shape`` INFER runs
a chromosome's (batch x seed) units on a (genome x seed) mesh
(``runner.infer_chromosome_meshed``). Under ``torch.distributed`` (torchrun,
parallel/launcher.py) rank 0 runs every stage and the other ranks join its
meshed INFER calls only.
"""

from __future__ import annotations

import json
import os
import platform
import sys
import time
from pathlib import Path

import numpy as np
import torch

from hygeia_tpu_torch import __version__ as _VERSION
from hygeia_tpu_torch.single_group import theta_config as _tc
from hygeia_tpu_torch.utils import io as hio


class StageTrace:
    """Per-stage wall-clock trace: ``trace.tsv``, ``timeline.html``,
    ``report.html``, ``dag.dot`` and ``versions.yml`` in the run directory,
    the JAX orchestrator's files (torch's and CUDA's versions in place of
    JAX's)."""

    def __init__(self, output_dir):
        self.path = Path(output_dir)
        self.rows = []

    def record(self, stage, chrom, seconds, skipped=False, attempts=1, status="ok"):
        self.rows.append((stage, str(chrom), round(seconds, 3), skipped, attempts, status))

    def flush(self):
        self.path.mkdir(parents=True, exist_ok=True)
        with open(self.path / "trace.tsv", "w") as f:
            f.write("stage\tchrom\twall_s\tskipped\tattempts\tstatus\n")
            for r in self.rows:
                f.write("\t".join(str(x) for x in r) + "\n")
        self._write_timeline()
        self._write_report()
        self._write_dag()
        with open(self.path / "versions.yml", "w") as f:
            f.write(f'hygeia_tpu_torch: "{_VERSION}"\npython: "{platform.python_version()}"\n'
                    f'torch: "{torch.__version__}"\ncuda: "{torch.version.cuda}"\n')

    def _write_timeline(self):
        total = max(sum(r[2] for r in self.rows), 1e-9)
        bars, acc = [], 0.0
        for stage, chrom, wall, skipped, attempts, status in self.rows:
            left, width = 100.0 * acc / total, max(100.0 * wall / total, 0.3)
            acc += wall
            colour = "#bbb" if skipped else "#d9534f" if str(status).startswith("ignored") else "#5b8def"
            label = f"{stage} [{chrom}] {wall:.2f}s" + (f" x{attempts}" if attempts > 1 else "")
            bars.append(
                f'<div class="row"><div class="bar" style="margin-left:{left:.2f}%;'
                f'width:{width:.2f}%;background:{colour}"></div>'
                f"<span>{label}</span></div>"
            )
        html = (
            "<!doctype html><meta charset='utf-8'><title>hygeia timeline</title>"
            "<style>body{font:12px sans-serif;margin:20px}.row{display:flex;"
            "align-items:center;margin:2px 0}.bar{height:12px;border-radius:2px;"
            "flex:none}span{margin-left:6px;white-space:nowrap}</style>"
            f"<h2>hygeia_tpu_torch run timeline — {total:.1f}s total</h2>" + "".join(bars)
        )
        (self.path / "timeline.html").write_text(html)

    def _write_report(self):
        rows = "".join(
            f"<tr><td>{s}</td><td>{c}</td><td>{w:.3f}</td><td>{sk}</td><td>{a}</td><td>{st}</td></tr>"
            for s, c, w, sk, a, st in self.rows
        )
        n_ignored = sum(1 for r in self.rows if str(r[5]).startswith("ignored"))
        html = (
            "<!doctype html><meta charset='utf-8'><title>hygeia report</title>"
            "<style>body{font:13px sans-serif;margin:20px}table{border-collapse:"
            "collapse}td,th{border:1px solid #ccc;padding:3px 8px}</style>"
            f"<h2>hygeia_tpu_torch run report</h2><p>{len(self.rows)} stage executions, "
            f"{n_ignored} ignored after retries, total {sum(r[2] for r in self.rows):.1f}s</p>"
            "<table><tr><th>stage</th><th>unit</th><th>wall_s</th>"
            "<th>skipped</th><th>attempts</th><th>status</th></tr>" + rows + "</table>"
        )
        (self.path / "report.html").write_text(html)

    def _write_dag(self):
        stages = []
        for s, *_ in self.rows:
            base = s.split("[")[0]
            if base not in stages:
                stages.append(base)
        edges = "".join(f'  "{a}" -> "{b}";\n' for a, b in zip(stages, stages[1:]))
        (self.path / "dag.dot").write_text(
            "digraph hygeia {\n  rankdir=LR;\n  node [shape=box, style=rounded];\n" + edges + "}\n")


def _attempt(fn, *, trace: StageTrace, stage, chrom, max_retries=5):
    """Run one work unit under the reference's error strategy: retry up to
    ``max_retries`` times, then ignore it. Each attempt gets its 1-based
    number, so a caller can shrink a memory-shaped knob per attempt (halve
    the seeds of an INFER chunk). Returns True if the unit succeeded, False
    if it was ignored after all retries; each failure is logged to stderr."""
    t0 = time.time()
    last_err = None
    for attempt in range(1, max_retries + 2):  # the first try + max_retries
        try:
            fn(attempt)
            trace.record(stage, chrom, time.time() - t0, attempts=attempt)
            return True
        except Exception as e:  # noqa: BLE001 — task isolation
            last_err = e
            print(f"{stage}[{chrom}] attempt {attempt} failed: {e!r}", file=sys.stderr, flush=True)
    trace.record(stage, chrom, time.time() - t0, attempts=max_retries + 1,
                 status=f"ignored: {type(last_err).__name__}")
    return False


def _marker(path: Path) -> Path:
    return path / ".done"


def _stage(path: Path, resume: bool):
    """True if the stage should run (and ensures its directory)."""
    path.mkdir(parents=True, exist_ok=True)
    return not (resume and _marker(path).exists())


def _open_mirror(bucket_dir, out: Path, resume, trace: StageTrace):
    """(WorkdirMirror, output root) for ``bucket_dir``, or None. On a
    resumed run the tree is first restored from the bucket (a
    ``BUCKET_RESTORE`` trace row counts the files fetched)."""
    if not bucket_dir:
        return None
    from hygeia_tpu_torch.utils.staging import WorkdirMirror

    mirror = WorkdirMirror(bucket_dir)
    if resume:
        fetched = mirror.restore(out)
        if fetched:
            trace.record("BUCKET_RESTORE", "-", 0.0, status=f"{fetched} files")
    return mirror, out


def _finish(path: Path, mirror, marker: Path | None = None):
    """Mark a stage done (``path/.done`` or ``marker``) and mirror the run's
    tree when a bucket is attached and the stage lies inside the run."""
    (marker or _marker(path)).write_text(json.dumps({"t": time.time()}))
    if mirror is not None:
        store, root = mirror
        if Path(path).resolve().is_relative_to(root.resolve()):
            store.sync_up(root)


def run_two_group(
    *,
    output_dir,
    chroms,
    device=None,
    cpg_file_path=None,
    control_data_paths=(),
    control_id_names=(),
    case_data_paths=(),
    case_id_names=(),
    preprocessed_dir=None,
    mu=(0.95, 0.05, 0.80, 0.20, 0.50, 0.50),
    sigma=(0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751),
    u=3,
    segment_size=100000,
    buffer_size=5000,
    inference_seeds=(0, 1),
    num_resampled_particles=50,
    num_samples_backward=25,
    n_particles_single_group=250,
    epsilon=0.01,
    n_steps_without_parameter_update=200,
    learning_rate_exponent=0.1,
    learning_rate_factor=0.01,
    fdr_thresholds=(0.01, 0.05),
    resume=True,
    rng_seed=0,
    stub_run=False,
    max_retries=5,
    mesh_shape=None,
    boundary="halo",
    streaming_blocks=None,
    stream_batched=False,
    bucket_dir=None,
):
    """The two-group pipeline for a list of chromosomes, the model stages on
    ``device`` (required unless ``stub_run``).

    Either BED inputs (cpg_file_path + *_data_paths) or a
    ``preprocessed_dir`` that holds the per-chromosome count files. With
    several chromosomes in ``preprocessed_dir`` mode the theta stage runs
    for all of them in one engine call (``_single_group_on_counts_batched``).
    stub_run=True writes the tree with empty files and computes nothing.
    ``streaming_blocks`` with ``stream_batched`` runs each chromosome's
    INFER through ``runner.infer_chromosome_streamed``; without
    ``stream_batched`` each batch's seeds run as one ``infer_segment`` call
    (streamed in blocks when ``streaming_blocks`` is given), retried with
    half the seeds of a chunk on each failure and then ignored; aggregation
    then skips the missing units."""
    if stream_batched and not streaming_blocks:
        raise ValueError(
            "stream_batched requires streaming_blocks (--run_stream_batched only applies to the "
            "streamed INFER path; set --run_streaming_blocks)")
    out = Path(output_dir)
    R = len(mu)
    n_backward_total = num_resampled_particles * (2 * R + R * R)
    trace = StageTrace(out)
    if stub_run:
        _stub_two_group(out, chroms, inference_seeds, n_backward_total)
        trace.flush()
        return out
    if device is None:
        raise ValueError("run_two_group needs a device for its model stages")
    device = torch.device(device)
    from hygeia_tpu_torch.parallel.launcher import initialize_distributed

    rank, world = initialize_distributed()
    if world > 1 and mesh_shape is None:
        raise ValueError(f"run over {world} ranks needs --mesh: only the meshed INFER spans ranks")
    if rank != 0:
        return _follow_meshed_infer(chroms, world, max_retries)
    mirror = _open_mirror(bucket_dir, out, resume, trace)
    sg_kw = dict(mu=mu, sigma=sigma, u=u, n_particles=n_particles_single_group, epsilon=epsilon,
                 steps_per_update=n_steps_without_parameter_update,
                 learning_rate_exponent=learning_rate_exponent,
                 learning_rate_factor=learning_rate_factor, rng_seed=rng_seed, device=device)

    sg_batched_done: set = set()
    if preprocessed_dir is not None and len(chroms) > 1:
        sg_root = out / "2_ESTIMATE_PARAMETERS_AND_REGIMES"
        pending = [c for c in chroms if _stage(sg_root / str(c), resume)]
        if len(pending) > 1:
            def _sg_batched(attempt):
                _single_group_on_counts_batched(
                    [(Path(preprocessed_dir), sg_root / str(c), c, "control") for c in pending], **sg_kw)
                for c in pending:
                    _finish(sg_root / str(c), mirror)

            if _attempt(_sg_batched, trace=trace, stage="ESTIMATE_PARAMETERS_AND_REGIMES[batched]",
                        chrom=",".join(map(str, pending)), max_retries=1):
                sg_batched_done.update(pending)

    for chrom in chroms:
        # ---- 1: preprocess ------------------------------------------------
        pre_dir = out / "1_PREPROCESS" / str(chrom)
        if preprocessed_dir is not None:
            pre_dir = Path(preprocessed_dir)
        elif _stage(pre_dir, resume):
            from hygeia_tpu_torch.pipeline.preprocess_bed import process_bed

            t0 = time.time()
            process_bed(cpg_file_path, pre_dir, chrom, control_data_paths=control_data_paths,
                        control_id_names=control_id_names, case_data_paths=case_data_paths,
                        case_id_names=case_id_names)
            trace.record("PREPROCESS", chrom, time.time() - t0)
            _finish(pre_dir, mirror)

        # ---- 2: single-group estimation on the control group -------------
        sg_dir = out / "2_ESTIMATE_PARAMETERS_AND_REGIMES" / str(chrom)
        if chrom not in sg_batched_done and _stage(sg_dir, resume):
            def _sg_stage(attempt):
                _single_group_on_counts(pre_dir, sg_dir, chrom, group="control", **sg_kw)
                _finish(sg_dir, mirror)

            if not _attempt(_sg_stage, trace=trace, stage="ESTIMATE_PARAMETERS_AND_REGIMES", chrom=chrom,
                            max_retries=max_retries):
                if mesh_shape is not None:
                    _send_plan(world, None)
                continue  # everything downstream needs theta
        else:
            trace.record("ESTIMATE_PARAMETERS_AND_REGIMES", chrom, 0.0, skipped=True)

        # ---- 3: segments --------------------------------------------------
        seg_dir = out / "3_GET_CHROM_SEGMENTS" / str(chrom)
        positions = hio.read_positions(pre_dir / f"positions_{chrom}.txt.gz")
        n_batches = 1 + len(positions) // segment_size
        if _stage(seg_dir, resume):
            from hygeia_tpu_torch.pipeline.segments import chrom_segments, write_segments_csv

            write_segments_csv(seg_dir / f"chrom_segments_{chrom}.csv",
                               chrom_segments(len(positions), str(chrom), segment_size))
            _finish(seg_dir, mirror)

        # ---- 4: infer over (batch x seed) ---------------------------------
        infer_dir = out / "4_INFER"
        infer_kw = dict(data_dir=str(pre_dir), single_group_dir=str(sg_dir), results_dir=str(infer_dir),
                        chrom=chrom, device=device, seed=list(inference_seeds),
                        segment_size=segment_size, buffer_size=buffer_size, mu=mu, sigma=sigma,
                        minimum_duration=u, num_resampled_particles=(num_resampled_particles,),
                        num_samples_backward=num_samples_backward, streaming_blocks=streaming_blocks)
        any_unit_failed = False
        if mesh_shape is not None:
            # The chromosome's (batch x seed) grid on the mesh: one marker and
            # one retry scope. Every rank makes the same call.
            unit = infer_dir / f"unit_{chrom}_meshed"
            mesh_kw = None
            if _stage(unit, resume):
                mesh_kw = dict(
                    data_dir=str(pre_dir), single_group_dir=str(sg_dir), results_dir=str(infer_dir),
                    chrom=chrom, device=device, mesh_shape=tuple(mesh_shape), boundary=boundary,
                    seed=list(inference_seeds), segment_size=segment_size, buffer_size=buffer_size, mu=mu,
                    sigma=sigma, minimum_duration=u, num_resampled_particles=(num_resampled_particles,),
                    num_samples_backward=num_samples_backward, rng_seed=rng_seed)
            n_units = n_batches * len(inference_seeds)
            _send_plan(world, None if mesh_kw is None else (mesh_kw, n_units))
            if mesh_kw is None:
                trace.record("INFER[mesh]", chrom, 0.0, skipped=True)
            else:
                from hygeia_tpu_torch.two_group.runner import infer_chromosome_meshed

                def _infer_meshed(attempt):
                    infer_chromosome_meshed(**mesh_kw, max_units_per_call=_units_cap(n_units, attempt))
                    _finish(unit, mirror)

                any_unit_failed |= not _attempt(_infer_meshed, trace=trace, stage="INFER[mesh]", chrom=chrom,
                                                max_retries=max_retries)
            seq_batches = ()
        elif stream_batched:
            from hygeia_tpu_torch.two_group.runner import infer_chromosome_streamed

            unit = infer_dir / f"unit_{chrom}_streambatched"
            if not _stage(unit, resume):
                trace.record("INFER[streambatched]", chrom, 0.0, skipped=True)
            else:
                def _infer_streambatched(attempt):
                    infer_chromosome_streamed(
                        **infer_kw,
                        max_units_per_call=max(1, (len(inference_seeds) * n_batches) >> (attempt - 1)))
                    _finish(unit, mirror)

                any_unit_failed |= not _attempt(_infer_streambatched, trace=trace, stage="INFER[streambatched]",
                                                chrom=chrom, max_retries=max_retries)
            seq_batches = ()
        else:
            seq_batches = range(n_batches)
        for batch in seq_batches:
            from hygeia_tpu_torch.two_group.runner import infer_segment

            unit = infer_dir / f"unit_{chrom}_{batch}"
            if not _stage(unit, resume):
                trace.record(f"INFER[{batch}]", chrom, 0.0, skipped=True)
                continue

            def _infer_unit(attempt, batch=batch, unit=unit):
                # Halve the seeds of a chunk on each retry, so that a run out
                # of device memory on the whole seed batch backs off.
                infer_segment(**infer_kw, batch=batch,
                              max_seeds_per_call=max(1, len(inference_seeds) >> (attempt - 1)))
                _finish(unit, mirror)

            any_unit_failed |= not _attempt(_infer_unit, trace=trace, stage=f"INFER[{batch}]", chrom=chrom,
                                            max_retries=max_retries)

        # ---- 5: aggregate -------------------------------------------------
        # A unit ignored after all retries must not lose the chromosome:
        # aggregate whatever completed.
        agg_dir = out / "5_AGGREGATE_RESULTS" / str(chrom)
        if _stage(agg_dir, resume):
            from hygeia_tpu_torch.pipeline.aggregate import aggregate_chromosome

            def _agg_stage(attempt):
                aggregate_chromosome(str(infer_dir), str(agg_dir), chrom, seeds=len(inference_seeds),
                                     num_particles=n_backward_total, num_batches=n_batches,
                                     skip_missing=any_unit_failed)
                _finish(agg_dir, mirror)

            if not _attempt(_agg_stage, trace=trace, stage="AGGREGATE_RESULTS", chrom=chrom,
                            max_retries=max_retries):
                continue

        # ---- 6: DMPs ------------------------------------------------------
        dmp_dir = out / "6_GET_DMPS" / str(chrom)
        if _stage(dmp_dir, resume):
            from hygeia_tpu_torch.pipeline.dmps import call_dmps

            def _dmp_stage(attempt):
                call_dmps(str(agg_dir), str(dmp_dir), chrom, n_regimes=R, fdr_thresholds=fdr_thresholds)
                _finish(dmp_dir, mirror)

            _attempt(_dmp_stage, trace=trace, stage="GET_DMPS", chrom=chrom, max_retries=max_retries)

    trace.flush()
    return out


def _send_plan(world, plan):
    """Rank 0's meshed INFER call for one chromosome ((its keyword
    arguments, the chromosome's units), or None: nothing runs), sent to
    every rank; returns it."""
    if world > 1:
        import torch.distributed as dist

        box = [plan]
        dist.broadcast_object_list(box, src=0)
        return box[0]
    return plan


def _follow_meshed_infer(chroms, world, max_retries):
    """A rank other than 0: join rank 0's meshed INFER call of every
    chromosome that runs one (one plan a chromosome), retried as rank 0
    retries it. Writes nothing."""
    from hygeia_tpu_torch.two_group.runner import infer_chromosome_meshed

    trace = StageTrace(os.devnull)  # for _attempt's records; never flushed
    for chrom in chroms:
        plan = _send_plan(world, None)
        if plan is not None:
            kw, n_units = plan
            _attempt(lambda attempt: infer_chromosome_meshed(**kw, max_units_per_call=_units_cap(n_units, attempt)),
                     trace=trace, stage="INFER[mesh]", chrom=chrom, max_retries=max_retries)
    return None


def _units_cap(n_units, attempt):
    """The meshed INFER's units a chunk on try ``attempt``: no cap on the
    first, then half the chromosome's (batch x seed) units on each retry,
    as the streamed path's retries back off."""
    return None if attempt == 1 else max(1, n_units >> (attempt - 1))


def _stub_two_group(out, chroms, inference_seeds, n_backward_total):
    """The full output tree with empty files (DAG wiring test)."""
    for chrom in chroms:
        for stage in (f"1_PREPROCESS/{chrom}", f"2_ESTIMATE_PARAMETERS_AND_REGIMES/{chrom}",
                      f"3_GET_CHROM_SEGMENTS/{chrom}", "4_INFER", f"5_AGGREGATE_RESULTS/{chrom}",
                      f"6_GET_DMPS/{chrom}"):
            (out / stage).mkdir(parents=True, exist_ok=True)
        for name in (f"1_PREPROCESS/{chrom}/positions_{chrom}.txt.gz",
                     f"2_ESTIMATE_PARAMETERS_AND_REGIMES/{chrom}/theta_{chrom}.csv.gz",
                     f"3_GET_CHROM_SEGMENTS/{chrom}/chrom_segments_{chrom}.csv",
                     f"5_AGGREGATE_RESULTS/{chrom}/split_probs_{chrom}.csv.gz",
                     f"6_GET_DMPS/{chrom}/dmp_0.05.csv"):
            (out / name).touch()
        for seed in inference_seeds:
            d = out / "4_INFER" / f"chrom_{chrom}_0"
            d.mkdir(parents=True, exist_ok=True)
            (d / f"optimal_backward_particles_merged_state_{n_backward_total}_{seed}.npz").touch()


def _sg_setup(units, *, mu, sigma, u, n_particles, epsilon, steps_per_update, learning_rate_exponent,
              learning_rate_factor, rng_seed, device, estimate_regimes=True, estimate_parameters=True,
              theta_fixed=None):
    """(model, config, initial theta, [(T_c, R) emission table],
    [positions]) of a single-group stage for [(pre_dir, chrom, group)]
    units. The initial theta: ``theta_fixed`` (one (D,) theta a unit, given
    as (U, D)) when given; else, when theta is estimated, N(0, I) from a CPU
    generator seeded with rng_seed, the same for every unit (the JAX
    package draws it with jax.random.normal, so the packages start from
    different theta); else the default P and omega (``runner.default_p``,
    ``DEFAULT_OMEGA``)."""
    from hygeia_tpu_torch.ops.emissions import emission_log_prob_table
    from hygeia_tpu_torch.single_group.engine import EngineConfig
    from hygeia_tpu_torch.single_group.model import make_model, parameters_to_theta
    from hygeia_tpu_torch.single_group.runner import DEFAULT_OMEGA, default_p

    R = len(mu)
    kappa = np.full(R, 2.0)
    model = make_model(np.asarray(mu), np.asarray(sigma), u, kappa, d_max=4096, device=device)
    if theta_fixed is not None:
        theta0 = torch.as_tensor(np.stack([np.asarray(t, np.float64) for t in theta_fixed]))
    elif estimate_parameters:
        gen = torch.Generator().manual_seed(int(rng_seed))
        theta0 = torch.randn((model.dim_theta,), generator=gen, dtype=torch.float64)
    else:
        theta0 = torch.as_tensor(parameters_to_theta(default_p(R), np.asarray(DEFAULT_OMEGA[:R]), kappa))
    tables, positions = [], []
    for pre_dir, chrom, group in units:
        pre_dir = Path(pre_dir)
        n_total = hio.read_count_matrix(pre_dir / f"n_total_reads_{group}_{chrom}.txt.gz")
        n_meth = hio.read_count_matrix(pre_dir / f"n_methylated_reads_{group}_{chrom}.txt.gz")
        positions.append(hio.read_positions(pre_dir / f"positions_{chrom}.txt.gz"))
        tables.append(emission_log_prob_table(n_meth, n_total, model.alpha, model.beta))
    cfg = EngineConfig(
        n_particles_max=n_particles, epsilon=epsilon, estimate_regimes=estimate_regimes,
        estimate_parameters=estimate_parameters, steps_per_update=steps_per_update,
        learning_rate_exponent=learning_rate_exponent, learning_rate_factor=learning_rate_factor,
    )
    return model, cfg, theta0.to(device, torch.float32), tables, positions


def _single_group_on_counts(
    pre_dir,
    sg_dir,
    chrom,
    *,
    group,
    mu,
    sigma,
    u,
    n_particles,
    epsilon,
    steps_per_update,
    learning_rate_exponent,
    learning_rate_factor,
    rng_seed,
    device,
    estimate_regimes=True,
    estimate_parameters=True,
    theta_fixed=None,
    theta_block_size=None,
    theta_halo=None,
    theta_block_threshold=None,
):
    """The single-group engine on one chromosome's count files, on
    ``device``: the sequential engine, or the blocked one
    (single_group/blocked.py) at theta_block_threshold CpGs or more; writes
    the reference-named outputs (theta_{chrom}.csv.gz and the rest; no
    regime file unless ``estimate_regimes``). ``theta_fixed``: the (D,)
    theta to start from (the regime pass of the single-group pipeline). The
    resampler's uniforms come from a generator on ``device`` seeded with
    rng_seed."""
    from hygeia_tpu_torch.single_group.blocked import run_online_combined_inference_blocked
    from hygeia_tpu_torch.single_group.engine import run_online_combined_inference

    theta_block_size = _tc.THETA_BLOCK_SIZE if theta_block_size is None else theta_block_size
    theta_halo = _tc.THETA_HALO if theta_halo is None else theta_halo
    if theta_block_threshold is None:
        theta_block_threshold = _tc.THETA_BLOCK_THRESHOLD
    model, cfg, theta, tables, positions = _sg_setup(
        [(pre_dir, chrom, group)], mu=mu, sigma=sigma, u=u, n_particles=n_particles, epsilon=epsilon,
        steps_per_update=steps_per_update, learning_rate_exponent=learning_rate_exponent,
        learning_rate_factor=learning_rate_factor, rng_seed=rng_seed, device=device,
        estimate_regimes=estimate_regimes, estimate_parameters=estimate_parameters,
        theta_fixed=None if theta_fixed is None else [theta_fixed])
    E = tables[0]
    gen = torch.Generator(device=device).manual_seed(int(rng_seed))
    if theta_block_size and E.shape[0] >= theta_block_threshold:
        res = run_online_combined_inference_blocked(model, theta.reshape(-1), E, cfg,
                                                    block_size=theta_block_size, halo=theta_halo,
                                                    generator=gen)
        probs, trace = res.regime_probs, res.theta_trace
    else:
        res = run_online_combined_inference(model, theta.reshape(-1), E, cfg, generator=gen)
        probs, trace = res.regime_probs[0].cpu().numpy(), res.theta_trace[0].cpu().numpy()
    _write_sg_outputs(sg_dir, chrom, positions[0], probs if estimate_regimes else None, trace,
                      model.n_regimes)


def _write_sg_outputs(sg_dir, chrom, positions, probs, trace, R):
    """The single-group stage's reference-named outputs:
    regime_probabilities_ (unless ``probs`` is None), theta_trace_ (the JAX
    package's native float format, %.9g), p_, omega_, kappa_ and
    theta_{chrom}.csv.gz."""
    from hygeia_tpu_torch.single_group.model import theta_to_parameters

    sg_dir = Path(sg_dir)
    sg_dir.mkdir(parents=True, exist_ok=True)
    if probs is not None:
        cols = [f"regime_{i + 1}" for i in range(R)]
        hio.write_float_table(sg_dir / f"regime_probabilities_{chrom}.csv.gz", probs,
                              index=np.asarray(positions[: len(probs)]),
                              header="genomic_position," + ",".join(cols))
    hio.write_float_table(sg_dir / f"theta_trace_{chrom}.csv.gz", trace,
                          header=",".join(f"theta_{i + 1}" for i in range(trace.shape[1])))
    final = theta_to_parameters(trace[-1], R)
    hio.write_headed_table(sg_dir / f"p_{chrom}.csv.gz", final["p"], [f"regime_{i + 1}" for i in range(R)])
    hio.write_headed_column(sg_dir / f"omega_{chrom}.csv.gz", final["omega"], "omega")
    hio.write_headed_column(sg_dir / f"kappa_{chrom}.csv.gz", np.full(R, 2.0), "kappa")
    hio.write_theta(sg_dir / f"theta_{chrom}.csv.gz", trace[-1])


def _single_group_on_counts_batched(
    units,  # [(pre_dir, sg_dir, chrom, group)]
    *,
    mu,
    sigma,
    u,
    n_particles,
    epsilon,
    steps_per_update,
    learning_rate_exponent,
    learning_rate_factor,
    rng_seed,
    device,
    estimate_parameters=True,
    estimate_regimes=True,
    theta_fixed=None,
):
    """The single-group engine for several (pre_dir, chromosome) units in
    one engine call on ``device``: each unit with its own table and length
    (t_limit), all of them taking the draws of one generator seeded with
    rng_seed, as the sequential stage's single unit does; so each unit's
    outputs are its sequential run's. ``theta_fixed``: one (D,) theta a
    unit (the regime pass of the single-group pipeline). When every unit
    reaches THETA_BLOCK_THRESHOLD the blocked stage runs instead, all
    (unit, block) windows in one call."""
    from hygeia_tpu_torch.single_group.blocked import run_online_combined_inference_blocked_multi
    from hygeia_tpu_torch.single_group.engine import run_online_combined_inference

    model, cfg, theta0, tables, positions = _sg_setup(
        [(pre, chrom, group) for pre, _sg, chrom, group in units], mu=mu, sigma=sigma, u=u,
        n_particles=n_particles, epsilon=epsilon, steps_per_update=steps_per_update,
        learning_rate_exponent=learning_rate_exponent, learning_rate_factor=learning_rate_factor,
        rng_seed=rng_seed, device=device, estimate_regimes=estimate_regimes,
        estimate_parameters=estimate_parameters, theta_fixed=theta_fixed)
    R, U = model.n_regimes, len(units)
    gen = torch.Generator(device=device).manual_seed(int(rng_seed))
    t_limits = [int(E.shape[0]) for E in tables]
    if min(t_limits) >= _tc.THETA_BLOCK_THRESHOLD:
        res_list = run_online_combined_inference_blocked_multi(
            model, list(theta0) if theta0.dim() == 2 else [theta0] * U, tables, cfg,
            block_size=_tc.THETA_BLOCK_SIZE, halo=_tc.THETA_HALO, generator=gen)
        outs = [(r.regime_probs, r.theta_trace) for r in res_list]
    else:
        E = torch.zeros((U, max(t_limits), R), dtype=torch.float32, device=device)
        for i, tab in enumerate(tables):
            E[i, : t_limits[i]] = tab  # rows past a unit's limit are never used
        res = run_online_combined_inference(model, theta0, E, cfg, n_units=U, generator=gen,
                                            shared_draws=True, t_limit=t_limits)
        probs, traces = res.regime_probs.cpu().numpy(), res.theta_trace.cpu().numpy()
        outs = [(probs[i, :T], traces[i, :T]) for i, T in enumerate(t_limits)]
    for (_pre, sg_dir, chrom, _g), (probs, trace), pos in zip(units, outs, positions):
        _write_sg_outputs(sg_dir, chrom, pos, probs if estimate_regimes else None, trace, R)


def read_sample_sheet(path):
    """The sample sheet's (sample_id, bed_path) rows: a CSV with ``id`` and
    ``file`` columns."""
    import csv

    with open(path, newline="") as f:
        return [(row["id"].strip(), row["file"].strip()) for row in csv.DictReader(f)]


def run_single_group(
    *,
    output_dir,
    chroms,
    device=None,
    samples=None,
    sample_sheet=None,
    raw_samples=None,
    cpg_file_path=None,
    mu=(0.99, 0.01, 0.80, 0.20, 0.50, 0.50),
    sigma=(0.05, 0.05, 0.20, 0.20, 0.20, 0.2886751),
    u=3,
    n_particles=250,
    epsilon=0.01,
    n_steps_without_parameter_update=200,
    learning_rate_exponent=0.1,
    learning_rate_factor=0.01,
    resume=True,
    rng_seed=0,
    stub_run=False,
    max_retries=5,
    group="case",
    bucket_dir=None,
):
    """The single-group pipeline, per (sample, chromosome):
    SINGLE_GRP_PREPROCESS (the sample's BED preprocessed as the ``case``
    group), ESTIMATE_PARAMETERS (theta learned from N(0, I), no regime
    pass), ESTIMATE_REGIMES (the regime pass from the learned theta) and
    GENERATE_SINGLE_GROUP_BED_FILES (BED9, bgzip and a tabix index), into

      1_PREPROCESS/{sample}/{chrom}/ 2_ESTIMATE_PARAMETERS/{sample}/{chrom}/
      3_ESTIMATE_REGIMES/{sample}/{chrom}/ 4_SINGLE_GROUP_OUTPUT/{sample}/

    Inputs: ``sample_sheet`` (or ``raw_samples``, its rows) and
    ``cpg_file_path``, or ``samples`` = [(sample_id, dir)] of directories
    already preprocessed (count files of ``group``). With more than one
    unit, each estimate first runs as one engine call over every pending
    unit (``ESTIMATE_PARAMETERS[batched]``, ``ESTIMATE_REGIMES[batched]``);
    a unit the batched pass did not finish runs alone. The engine stages run
    on ``device``; markers make a re-run skip finished stages."""
    out = Path(output_dir)
    trace = StageTrace(out)
    if sample_sheet is not None and raw_samples is None:
        raw_samples = read_sample_sheet(sample_sheet)
    if stub_run:
        _stub_single_group(out, chroms, [s for s, _ in (raw_samples or samples or ())])
        trace.flush()
        return out
    if device is None:
        raise ValueError("run_single_group needs a device for its model stages")
    device = torch.device(device)
    from hygeia_tpu_torch.parallel.launcher import initialize_distributed

    if initialize_distributed()[0] != 0:
        return None  # no stage spans ranks: rank 0 runs them all
    mirror = _open_mirror(bucket_dir, out, resume, trace)

    units = []  # (sample_id, chrom, pre_dir, group)
    if raw_samples is not None:
        from hygeia_tpu_torch.pipeline.preprocess_bed import process_bed

        for sample_id, bed_path in raw_samples:
            for chrom in chroms:
                pre_dir = out / "1_PREPROCESS" / sample_id / str(chrom)
                if _stage(pre_dir, resume):
                    def _pre_stage(attempt, sample_id=sample_id, bed_path=bed_path, chrom=chrom,
                                   pre_dir=pre_dir):
                        process_bed(cpg_file_path, pre_dir, chrom, case_data_paths=[bed_path],
                                    case_id_names=[sample_id])
                        _finish(pre_dir, mirror)

                    if not _attempt(_pre_stage, trace=trace, stage="SINGLE_GRP_PREPROCESS",
                                    chrom=f"{sample_id}:{chrom}", max_retries=max_retries):
                        continue
                else:
                    trace.record("SINGLE_GRP_PREPROCESS", f"{sample_id}:{chrom}", 0.0, skipped=True)
                units.append((sample_id, chrom, pre_dir, "case"))
    else:
        for sample_id, pre_dir in samples:
            for chrom in chroms:
                units.append((sample_id, chrom, Path(pre_dir), group))

    sg_kw = dict(mu=mu, sigma=sigma, u=u, n_particles=n_particles, epsilon=epsilon,
                 steps_per_update=n_steps_without_parameter_update,
                 learning_rate_exponent=learning_rate_exponent,
                 learning_rate_factor=learning_rate_factor, rng_seed=rng_seed, device=device)

    def est_dir_of(sid, ch):
        return out / "2_ESTIMATE_PARAMETERS" / sid / str(ch)

    def reg_dir_of(sid, ch):
        return out / "3_ESTIMATE_REGIMES" / sid / str(ch)

    est_batched_done: set = set()  # in-process, so --no_resume does not rerun them
    reg_batched_done: set = set()
    if len(units) > 1:
        pending1 = [(pre, est_dir_of(sid, ch), ch, grp) for sid, ch, pre, grp in units
                    if _stage(est_dir_of(sid, ch), resume)]
        if len(pending1) > 1:
            def _est_batched(attempt):
                _single_group_on_counts_batched(pending1, estimate_parameters=True,
                                                estimate_regimes=False, **sg_kw)
                for _pre, d, _c, _g in pending1:
                    _finish(d, mirror)

            if _attempt(_est_batched, trace=trace, stage="ESTIMATE_PARAMETERS[batched]",
                        chrom=f"{len(pending1)} units", max_retries=1):
                est_batched_done.update(d for _pre, d, _c, _g in pending1)
        pending2, theta2 = [], []
        for sid, ch, pre, grp in units:
            theta_file = est_dir_of(sid, ch) / f"theta_{ch}.csv.gz"
            if _stage(reg_dir_of(sid, ch), resume) and theta_file.exists():
                pending2.append((pre, reg_dir_of(sid, ch), ch, grp))
                theta2.append(hio.read_theta(theta_file))
        if len(pending2) > 1:
            def _reg_batched(attempt):
                _single_group_on_counts_batched(pending2, estimate_parameters=False,
                                                estimate_regimes=True, theta_fixed=theta2, **sg_kw)
                for _pre, d, _c, _g in pending2:
                    _finish(d, mirror)

            if _attempt(_reg_batched, trace=trace, stage="ESTIMATE_REGIMES[batched]",
                        chrom=f"{len(pending2)} units", max_retries=1):
                reg_batched_done.update(d for _pre, d, _c, _g in pending2)

    for sample_id, chrom, pre_dir, grp in units:
        unit_tag = f"{sample_id}:{chrom}"
        est_dir = est_dir_of(sample_id, chrom)
        if est_dir not in est_batched_done and _stage(est_dir, resume):
            def _est_stage(attempt):
                _single_group_on_counts(pre_dir, est_dir, chrom, group=grp, estimate_regimes=False,
                                        estimate_parameters=True, **sg_kw)
                _finish(est_dir, mirror)

            if not _attempt(_est_stage, trace=trace, stage="ESTIMATE_PARAMETERS", chrom=unit_tag,
                            max_retries=max_retries):
                continue
        else:
            trace.record("ESTIMATE_PARAMETERS", unit_tag, 0.0, skipped=True)

        reg_dir = reg_dir_of(sample_id, chrom)
        if reg_dir not in reg_batched_done and _stage(reg_dir, resume):
            def _reg_stage(attempt):
                theta = hio.read_theta(est_dir / f"theta_{chrom}.csv.gz")
                _single_group_on_counts(pre_dir, reg_dir, chrom, group=grp, estimate_regimes=True,
                                        estimate_parameters=False, theta_fixed=theta, **sg_kw)
                _finish(reg_dir, mirror)

            if not _attempt(_reg_stage, trace=trace, stage="ESTIMATE_REGIMES", chrom=unit_tag,
                            max_retries=max_retries):
                continue
        else:
            trace.record("ESTIMATE_REGIMES", unit_tag, 0.0, skipped=True)

        bed_dir = out / "4_SINGLE_GROUP_OUTPUT" / sample_id
        bed_marker = bed_dir / f".done_{chrom}"
        if not (resume and bed_marker.exists()):
            bed_dir.mkdir(parents=True, exist_ok=True)

            def _bed_stage(attempt):
                from hygeia_tpu_torch.pipeline.bed import make_bed

                make_bed(chrom, reg_dir / f"regime_probabilities_{chrom}.csv.gz",
                         bed_dir / f"{sample_id}_regimes_{chrom}.bed", compress=True)
                _finish(bed_dir, mirror, marker=bed_marker)

            _attempt(_bed_stage, trace=trace, stage="GENERATE_SINGLE_GROUP_BED_FILES", chrom=unit_tag,
                     max_retries=max_retries)
        else:
            trace.record("GENERATE_SINGLE_GROUP_BED_FILES", unit_tag, 0.0, skipped=True)

    trace.flush()
    return out


def _stub_single_group(out, chroms, sample_ids):
    """The single-group output tree with empty files (DAG wiring test)."""
    for sample_id in sample_ids:
        for chrom in chroms:
            for stage, names in (
                (f"1_PREPROCESS/{sample_id}/{chrom}",
                 (f"positions_{chrom}.txt.gz", f"n_total_reads_case_{chrom}.txt.gz",
                  f"n_methylated_reads_case_{chrom}.txt.gz", f"cpg_sites_merged_{chrom}.txt.gz")),
                (f"2_ESTIMATE_PARAMETERS/{sample_id}/{chrom}",
                 (f"theta_trace_{chrom}.csv.gz", f"p_{chrom}.csv.gz", f"kappa_{chrom}.csv.gz",
                  f"omega_{chrom}.csv.gz", f"theta_{chrom}.csv.gz")),
                (f"3_ESTIMATE_REGIMES/{sample_id}/{chrom}", (f"regime_probabilities_{chrom}.csv.gz",)),
                (f"4_SINGLE_GROUP_OUTPUT/{sample_id}",
                 (f"{sample_id}_regimes_{chrom}.bed.gz", f"{sample_id}_regimes_{chrom}.bed.gz.tbi")),
            ):
                d = out / stage
                d.mkdir(parents=True, exist_ok=True)
                for name in names:
                    (d / name).touch()
