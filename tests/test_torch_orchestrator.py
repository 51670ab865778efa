"""The port's ``run --two_group`` (hygeia_tpu_torch.pipeline.orchestrator)
on the CPU: its stage tree against the JAX orchestrator's, a whole run from
BED files to DMP calls at a tiny size (M=3, B=4, N=30 single-group
particles, a 420-CpG chromosome in 3 batches), resume, retry and ignore,
the batched theta stage, and the options that are not ported."""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from hygeia_tpu.cli import main as jax_cli
from hygeia_tpu_torch import cli as torch_cli
from hygeia_tpu_torch.pipeline import orchestrator as orch
from hygeia_tpu_torch.utils import io as tio

torch.set_num_threads(1)

TINY = ["--batch_size", "150", "--buffer_size", "20", "--num_resampled_particles", "3",
        "--num_samples_backward", "4", "--n_particles", "30", "--device", "cpu"]


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())


@pytest.fixture(scope="module")
def beds(tmp_path_factory):
    root = tmp_path_factory.mktemp("beds")
    cpg, controls, cases, dmr, pos = chip_smoke.make_bed_dataset(str(root), 420, seed=5, chrom="3",
                                                                 n_dmr=1, dmr_len=60)
    args = ["--cpg_file_path", cpg]
    for p in controls:
        args += ["--control_data_path", p]
    for p in cases:
        args += ["--case_data_path", p]
    args += ["--control_id_names", "c0", "--control_id_names", "c1",
             "--case_id_names", "k0", "--case_id_names", "k1"]
    return args


@pytest.fixture(scope="module")
def real_run(beds, tmp_path_factory):
    out = tmp_path_factory.mktemp("run") / "out"
    torch_cli.main(["run", "--two_group", "--output_dir", str(out), "--chroms", "3", *beds, *TINY])
    return out


def test_stub_run_writes_the_jax_stub_tree(tmp_path):
    trees = {}
    for name, cli, extra in (("jax", jax_cli, []), ("torch", torch_cli.main, ["--device", "cuda"])):
        out = tmp_path / name
        cli(["run", "--two_group", "--stub_run", "--output_dir", str(out), "--chroms", "chrA,chrB", *extra])
        trees[name] = _files(out)
    assert trees["jax"] == trees["torch"]
    assert "6_GET_DMPS/chrB/dmp_0.05.csv" in trees["torch"]
    assert "torch" in (tmp_path / "torch" / "versions.yml").read_text()


def test_real_run_writes_the_stub_tree_and_dmps(real_run, tmp_path):
    torch_cli.main(["run", "--two_group", "--stub_run", "--output_dir", str(tmp_path), "--chroms", "3", *TINY])
    real = set(_files(real_run))
    assert set(_files(tmp_path)) <= real
    for name in ("trace.tsv", "timeline.html", "report.html", "dag.dot", "versions.yml"):
        assert name in real
    assert "1_PREPROCESS/3/n_total_reads_case_3.txt.gz" in real
    for b in range(3):  # 420 // 150 + 1 batches, two seeds each
        for s in (0, 1):
            assert f"4_INFER/chrom_3_{b}/optimal_backward_particles_case_state_144_{s}.npz" in real
        assert f"4_INFER/unit_3_{b}/.done" in real
    for f in ("theta_3.csv.gz", "theta_trace_3.csv.gz", "regime_probabilities_3.csv.gz", "p_3.csv.gz"):
        assert f"2_ESTIMATE_PARAMETERS_AND_REGIMES/3/{f}" in real
    for f in ("dmp_0.01.csv", "dmp_0.05.csv", "weighted_dmp_0.01.csv", "weighted_dmp_0.05.csv"):
        assert f"6_GET_DMPS/3/{f}" in real
    header, index, regimes = tio.read_int_table(real_run / "5_AGGREGATE_RESULTS/3/control_regimes_chrom_3.csv.gz")
    assert regimes.shape == (420, 8) and header[0] == "pos"
    np.testing.assert_array_equal(index, tio.read_positions(real_run / "1_PREPROCESS/3/positions_3.txt.gz"))
    trace = (real_run / "trace.tsv").read_text().splitlines()
    assert all("\tok" in row for row in trace[1:]), trace


def test_resumed_run_recomputes_nothing(real_run, beds):
    stamp = {f: os.stat(real_run / f).st_mtime_ns for f in _files(real_run)
             if not f.endswith((".tsv", ".html", ".dot", ".yml"))}
    torch_cli.main(["run", "--two_group", "--output_dir", str(real_run), "--chroms", "3", *beds, *TINY])
    after = {f: os.stat(real_run / f).st_mtime_ns for f in stamp}
    assert after == stamp
    rows = [r.split("\t") for r in (real_run / "trace.tsv").read_text().splitlines()[1:]]
    assert rows and all(r[3] == "True" for r in rows), rows  # every recorded stage skipped


def test_failing_infer_unit_is_retried_with_halved_seeds_then_ignored(beds, tmp_path, monkeypatch):
    """Batch 1 fails inside its backward pass (after its early input files)
    on every attempt: its retries halve the seeds of a chunk (4 seeds:
    4, 2, 1, 1), then it is ignored; aggregation skips it and the DMP stage
    still runs."""
    import hygeia_tpu_torch.two_group.runner as runner_mod

    real_infer, real_backward = runner_mod.infer_segment, runner_mod.backward_simulation
    caps = []

    def flaky(**kw):
        if kw["batch"] != 1:
            return real_infer(**kw)
        caps.append(kw["max_seeds_per_call"])

        def boom(*a, **k):
            raise RuntimeError("injected failure")

        runner_mod.backward_simulation = boom
        try:
            return real_infer(**kw)
        finally:
            runner_mod.backward_simulation = real_backward

    monkeypatch.setattr(runner_mod, "infer_segment", flaky)
    out = tmp_path / "out"
    argv = ["run", "--two_group", "--output_dir", str(out), "--chroms", "3", *beds, *TINY,
            "--num_of_inference_seeds", "4", "--max_retries", "3"]
    torch_cli.main(argv)
    assert caps == [4, 2, 1, 1]
    rows = {r.split("\t")[0]: r.split("\t") for r in (out / "trace.tsv").read_text().splitlines()[1:]}
    assert rows["INFER[1]"][4] == "4" and rows["INFER[1]"][5].startswith("ignored")
    assert rows["AGGREGATE_RESULTS"][5] == "ok" and rows["GET_DMPS"][5] == "ok"
    _, index, _ = tio.read_int_table(out / "5_AGGREGATE_RESULTS/3/merge_states_chrom_3.csv.gz")
    assert index.size == 150 + 120  # batches 0 and 2
    assert (out / "6_GET_DMPS/3/weighted_dmp_0.05.csv").exists()


def test_batched_theta_stage_equals_per_chromosome_runs(beds, tmp_path):
    """Two chromosomes of 420 and 300 CpGs in one engine call (t_limit,
    every unit the draws of the one generator) write each chromosome's
    sequential run's files."""
    pre = tmp_path / "pre"
    for chrom, n, seed in (("3", 420, 5), ("4", 300, 6)):
        cpg, c, k, _, _ = chip_smoke.make_bed_dataset(str(tmp_path / chrom), n, seed=seed, chrom=chrom,
                                                      n_dmr=1, dmr_len=60)
        from hygeia_tpu_torch.pipeline.preprocess_bed import process_bed

        process_bed(cpg, pre, chrom, control_data_paths=c, control_id_names=["a", "b"],
                    case_data_paths=k, case_id_names=["c", "d"])
    kw = dict(mu=chip_smoke.MU, sigma=chip_smoke.SIGMA, u=3, n_particles=30, epsilon=0.01, steps_per_update=50,
              learning_rate_exponent=0.1, learning_rate_factor=0.01, rng_seed=0, device="cpu")
    orch._single_group_on_counts_batched([(pre, tmp_path / "b" / c, c, "control") for c in ("3", "4")], **kw)
    for c in ("3", "4"):
        orch._single_group_on_counts(pre, tmp_path / "s" / c, c, group="control", **kw)
        names = sorted(os.listdir(tmp_path / "s" / c))
        assert names == sorted(os.listdir(tmp_path / "b" / c)) and len(names) == 6
        for name in names:
            assert (tio._read_text(tmp_path / "s" / c / name) == tio._read_text(tmp_path / "b" / c / name)), name


# The single-group run and preprocess --format gembs are ported; --mesh and
# --bucket_dir still raise, with and without --two_group.
@pytest.mark.parametrize("argv", [
    ["run", "--two_group", "--mesh", "2x1"],
    ["run", "--two_group", "--bucket_dir", "x"],
    ["run", "--sample_sheet", "x.csv", "--bucket_dir", "x"],
    ["run", "--sample_sheet", "x.csv", "--stub_run", "--bucket_dir", "x"],
])
def test_unported_options_raise(tmp_path, argv):
    extra = ["--output_dir", str(tmp_path / "o"), "--chroms", "3", "--device", "cpu"] if argv[0] == "run" else []
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_cli.main([*argv, *extra])


def test_run_device_cuda_raises_without_cuda(beds, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    argv = ["run", "--two_group", "--output_dir", str(tmp_path / "o"), "--chroms", "3", *beds, *TINY[:-1], "cuda"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_cli.main(argv)
    assert not (tmp_path / "o").exists()


def test_infer_segment_caps_the_seeds_of_a_chunk(tmp_path, monkeypatch):
    """max_seeds_per_call=2 runs seeds (0, 1, 2) in chunks of 2 and 1 (the
    memory budget alone would run them in one)."""
    import hygeia_tpu_torch.two_group.runner as runner_mod
    from tests.test_torch_streaming import BB, MM, MU, SIGMA, _write_chromosome

    data, sg = _write_chromosome(tmp_path, "c", 60, 2)
    chunks = []
    real = runner_mod.run_filter

    def recording(*a, **kw):
        chunks.append(kw["n_units"])
        return real(*a, **kw)

    monkeypatch.setattr(runner_mod, "run_filter", recording)
    kw = dict(data_dir=str(data), single_group_dir=str(sg), chrom="c", device="cpu", seed=[0, 1, 2],
              segment_size=60, buffer_size=0, mu=MU, sigma=SIGMA, num_resampled_particles=(MM,),
              num_samples_backward=BB)
    log_z = runner_mod.infer_segment(results_dir=str(tmp_path / "a"), max_seeds_per_call=2, **kw)
    runner_mod.infer_segment(results_dir=str(tmp_path / "b"), **kw)
    assert chunks == [2, 1, 3]
    assert sorted(log_z) == [0, 1, 2] and all(np.isfinite(v[MM * 15]) for v in log_z.values())


def test_model_constructors_need_a_device():
    """make_params, params_from_numpy, make_model and model_from_numpy take
    the device with no default: leaving it out raises instead of building
    CPU tensors."""
    from hygeia_tpu_torch.single_group import model as sm
    from hygeia_tpu_torch.two_group import model as tm

    R = 3
    two = dict(mu=[0.1, 0.5, 0.9], sigma=[0.08] * 3, p_softmax_control=np.zeros((R, R)),
               omega_logit_control=np.full(R, 2.0), omega_case=0.8, kappa_control=np.full(R, 2.0),
               kappa_case=np.full(R, 2.0), merge_log_prob=np.log(0.1), split_prob=0.01,
               minimum_duration=3, d_max=16)
    params = tm.make_params(**two, device="cpu")
    arrays = {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in vars(params).items()}
    model = sm.make_model([0.1, 0.5, 0.9], [0.08] * 3, 2, np.full(R, 2.0), device="cpu")
    m_arrays = {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in model._asdict().items()}
    for call in (lambda **d: tm.make_params(**two, **d), lambda **d: tm.params_from_numpy(arrays, **d),
                 lambda **d: sm.make_model([0.1, 0.5, 0.9], [0.08] * 3, 2, np.full(R, 2.0), **d),
                 lambda **d: sm.model_from_numpy(m_arrays, np.zeros(R * R), **d)):
        with pytest.raises(TypeError, match="device"):
            call()
        assert call(device="cpu") is not None


def test_theta_stage_takes_the_blocked_path_past_the_threshold(beds, tmp_path, monkeypatch):
    """With the threshold lowered to 300 CpGs, the per-chromosome stage runs
    run_online_combined_inference_blocked (its files: T rows, the last
    theta row is the theta file) and the batched stage of two chromosomes
    past it runs the blocked stage of both in one call."""
    from hygeia_tpu_torch.pipeline.preprocess_bed import process_bed
    from hygeia_tpu_torch.single_group import blocked

    pre = tmp_path / "pre"
    for chrom, n, seed in (("3", 420, 5), ("4", 300, 6)):
        cpg, c, k, _, _ = chip_smoke.make_bed_dataset(str(tmp_path / chrom), n, seed=seed, chrom=chrom,
                                                      n_dmr=1, dmr_len=60)
        process_bed(cpg, pre, chrom, control_data_paths=c, control_id_names=["a", "b"],
                    case_data_paths=k, case_id_names=["c", "d"])
    calls = []
    real = blocked.run_online_combined_inference_blocked_multi

    def spy(model, thetas, tables, *a, **kw):
        calls.append([int(t.shape[0]) for t in tables])
        return real(model, thetas, tables, *a, **kw)

    monkeypatch.setattr(blocked, "run_online_combined_inference_blocked_multi", spy)
    kw = dict(mu=chip_smoke.MU, sigma=chip_smoke.SIGMA, u=3, n_particles=30, epsilon=0.01, steps_per_update=50,
              learning_rate_exponent=0.1, learning_rate_factor=0.01, rng_seed=0, device="cpu")
    orch._single_group_on_counts(pre, tmp_path / "s" / "3", "3", group="control", theta_block_size=128,
                                 theta_halo=32, theta_block_threshold=300, **kw)
    monkeypatch.setattr(orch._tc, "THETA_BLOCK_THRESHOLD", 300)
    monkeypatch.setattr(orch._tc, "THETA_BLOCK_SIZE", 128)
    monkeypatch.setattr(orch._tc, "THETA_HALO", 32)
    orch._single_group_on_counts_batched([(pre, tmp_path / "b" / c, c, "control") for c in ("3", "4")], **kw)
    assert calls == [[420], [420, 300]]
    for d, c, n in ((tmp_path / "s" / "3", "3", 420), (tmp_path / "b" / "3", "3", 420), (tmp_path / "b" / "4", "4", 300)):
        header, trace = tio.read_headed_table(d / f"theta_trace_{c}.csv.gz")
        assert trace.shape == (n, 36) and np.isfinite(trace).all()
        np.testing.assert_allclose(trace[-1], tio.read_theta(d / f"theta_{c}.csv.gz"), rtol=1e-6)
        probs = tio.read_headed_table(d / f"regime_probabilities_{c}.csv.gz")[1]
        assert probs.shape == (n, 7)
        np.testing.assert_allclose(probs[:, 1:].sum(1), 1.0, atol=1e-5)
