"""The port's meshed INFER (hygeia_tpu_torch/parallel/, runner.
infer_chromosome_meshed) on the CPU: block windows and the halo scheme
against the JAX package's, the exchange scheme against exact inference, a
unit against its one-unit run, worlds of 2 and 4 gloo processes against
one, the pipeline's meshed branch, robust mode, the padding rows, the
launch formulas and the probe kernel's plain version."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hygeia_tpu_torch.ops import probe as tprobe
from hygeia_tpu_torch.parallel import make_mesh, sharded_two_group_inference
from hygeia_tpu_torch.parallel import sharded as tsh
from hygeia_tpu_torch.two_group import model as tm
from hygeia_tpu_torch.two_group.backward import backward_simulation, smoothing_functionals
from hygeia_tpu_torch.two_group.filter import run_filter
from tests.test_two_group_model import default_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
F64 = torch.float64


def _port_params(params):
    return tm.params_from_numpy({k: np.array(v) for k, v in params._asdict().items()}, device="cpu")


def _counts(T, seed, S=2):
    rng = np.random.default_rng(seed)
    n = rng.poisson(15, size=(T, S)).astype(np.float32)
    n[rng.random(T) < 0.1] = 0  # zero-read sites inside the chromosome too
    y = np.minimum(rng.poisson(6, size=(T, S)), n).astype(np.float32)
    return y, n


@pytest.mark.parametrize("T,seg,buf,n_blocks", [(10, 4, 2, 3), (37, 8, 3, 8), (16, 16, 0, 1), (5, 4, 4, 2)])
def test_make_block_windows_equals_jax(T, seg, buf, n_blocks):
    """The numpy windows are the JAX package's (the first case is
    tests/test_sharded.py::test_block_windows_padding's)."""
    from hygeia_tpu.parallel.sharded import make_block_windows as jax_windows

    arr = np.arange(2 * T, dtype=np.float64).reshape(T, 2) + 1
    got = tsh.make_block_windows(arr, seg, buf, n_blocks)
    want = jax_windows(arr, seg, buf, n_blocks)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.fixture(scope="module")
def simulated():
    """tests/test_sharded.py's chromosome: R=4, T=240, 40 reads a sample."""
    from hygeia_tpu.two_group.simulate import simulate

    R = 4
    params = default_params(R=R, min_duration=2, d_max=128)
    T = 240
    n_tot = np.full((T, 2), 40.0)
    sim = simulate(jax.random.PRNGKey(0), params, n_tot, n_tot)
    return params, np.asarray(sim.obs_control), np.asarray(sim.obs_case), n_tot, np.asarray(sim.states)


def _mode_recovery(traj, truth, R):
    mode = np.array([np.bincount(traj[t, :, 2], minlength=R).argmax() for t in range(traj.shape[0])])
    return float(np.mean(mode == truth[:, 2]))


def test_halo_matches_jax(simulated):
    """Both packages on tests/test_sharded.py's simulated chromosome, mesh
    4x2, f64: the JAX shapes, control-regime recovery above 0.85 (that
    test's bound) in both, and the port's per-site split and regime
    probabilities within 0.1 (mean absolute) of JAX's (2 seeds x 30
    trajectories a site; the realisations differ: threefry keys against
    per-unit torch generators)."""
    from hygeia_tpu.parallel import make_mesh as jax_mesh, sharded_two_group_inference as jax_sharded
    from hygeia_tpu.two_group.backward import smoothing_functionals as jax_functionals

    params, y_c, y_k, n_tot, states = simulated
    R = params.n_regimes
    kw = dict(segment_size=60, buffer_size=20, num_resampled_ancestors=20, num_samples_backward=30, seeds=[0, 1])
    j_traj, j_lz = jax_sharded(jax_mesh(n_genome=4, n_seed=2), params, y_c, n_tot, y_k, n_tot,
                               weight_dtype=jnp.float64, **kw)
    t_traj, t_lz = sharded_two_group_inference(make_mesh(4, 2, device="cpu"), _port_params(params), y_c, n_tot,
                                               y_k, n_tot, weight_dtype=F64, **kw)
    assert t_traj.shape == j_traj.shape == (240, 60, 5)
    assert t_lz.shape == j_lz.shape == (4, 2)
    assert np.isfinite(t_lz).all()
    assert _mode_recovery(j_traj, states, R) > 0.85
    assert _mode_recovery(t_traj, states, R) > 0.85
    j_split, j_regime = (np.asarray(a) for a in jax_functionals(jnp.asarray(j_traj), R))
    t_split, t_regime = (a[0].numpy() for a in smoothing_functionals(torch.from_numpy(t_traj[None]), R))
    assert t_split.shape == j_split.shape == (240,) and t_regime.shape == j_regime.shape == (240, 2 * R)
    assert np.abs(t_split - j_split).mean() < 0.1
    assert np.abs(t_regime - j_regime).mean() < 0.1


def _small_params(R=4, d_max=64):
    return _port_params(default_params(R=R, min_duration=2, d_max=d_max))


@pytest.mark.parametrize("budget_gb", [None, 1e-4])
def test_halo_unit_is_its_one_unit_run(monkeypatch, budget_gb):
    """Unit (b, s) of a meshed halo call equals run_filter +
    backward_simulation on window b alone with that unit's generators, bit
    for bit; at a budget of ~105 KB (chunks of one unit) the call gives the
    same bits as in one chunk."""
    if budget_gb is not None:
        monkeypatch.setenv("HYGEIA_HBM_BUDGET_GB", str(budget_gb))
    params = _small_params()
    y, n = _counts(70, 3)
    seg, buf, M, B, seeds = 16, 4, 4, 5, [3, 7]
    tim = {}
    traj, log_z = sharded_two_group_inference(
        make_mesh(2, 2, device="cpu"), params, y, n, y, n, segment_size=seg, buffer_size=buf,
        num_resampled_ancestors=M, num_samples_backward=B, seeds=seeds, base_key=11, weight_dtype=F64,
        timings=tim)
    n_blocks = 6  # ceil(70 / 16) = 5, rounded up to the genome axis
    assert traj.shape == (n_blocks * seg, 2 * B, 5) and log_z.shape == (n_blocks, 2)
    assert tim["chunks"] == ([12] if budget_gb is None else [1] * 12)  # 6 blocks x 2 seeds
    E_c, E_k = tsh.window_tables(params, (y, n, y, n), 70, seg, buf, n_blocks)
    for b in (0, 3, 5):
        for i, s in enumerate(seeds):
            res = run_filter(params, E_c[b], E_k[b], M, n_units=1, weight_dtype=F64,
                             generator=tsh.unit_generator("cpu", tsh.FILTER, 11, b, s))
            alone = backward_simulation(params, res.log_weights, res.particles, B,
                                        generator=tsh.unit_generator("cpu", tsh.BACKWARD, 11, b, s))
            assert np.array_equal(traj[b * seg : (b + 1) * seg, i * B : (i + 1) * B],
                                  alone[0, buf : buf + seg].numpy()), (b, s)
            assert log_z[b, i] == float(res.log_normalizing_constant[0]), (b, s)


def test_exchange_matches_exact_inference():
    """tests/test_sharded.py::test_exchange_boundary_matches_exact_inference
    on the port: T=10, R=3, mesh 2x4, M=60, B=500, f64, phantom regime 1;
    the summed window logZ within atol 0.1 of the enumerated one and the
    split and regime marginals within atol 0.05 (JAX's tolerances)."""
    from hygeia_tpu.ops.emissions import emission_log_prob_table as j_emission
    from tests.test_torch_two_group import _exact_forward_backward

    T, R = 10, 3
    params = default_params(R=R, min_duration=2, d_max=32)
    rng = np.random.default_rng(11)
    n_c = rng.poisson(25, size=(T, 1)).astype(np.float64)
    n_k = rng.poisson(25, size=(T, 1)).astype(np.float64)
    y_c = np.minimum(rng.poisson(10, size=(T, 1)), n_c)
    y_k = np.minimum(rng.poisson(10, size=(T, 1)), n_k)
    E_c = j_emission(y_c, n_c, params.alpha, params.beta, dtype=jnp.float64)
    E_k = j_emission(y_k, n_k, params.alpha, params.beta, dtype=jnp.float64)
    log_z_exact, split_exact, ctrl_exact, case_exact = _exact_forward_backward(params, E_c, E_k, 1, T)

    traj, log_z = sharded_two_group_inference(
        make_mesh(2, 4, device="cpu"), _port_params(params), y_c, n_c, y_k, n_k, segment_size=5,
        buffer_size=3, num_resampled_ancestors=60, num_samples_backward=500, seeds=[0, 1, 2, 3],
        weight_dtype=F64, boundary="exchange", phantom_regime=1)
    assert traj.shape == (10, 4 * 500, 5) and log_z.shape == (2, 4)
    np.testing.assert_allclose(log_z.sum(axis=0), log_z_exact, atol=0.1)
    split, regime = (a[0].numpy() for a in smoothing_functionals(torch.from_numpy(traj[None]), R))
    np.testing.assert_allclose(split, split_exact, atol=0.05)
    np.testing.assert_allclose(regime[:, :R], ctrl_exact, atol=0.05)
    np.testing.assert_allclose(regime[:, R:], case_exact, atol=0.05)


def test_exchange_with_one_genome_shard_is_the_monolithic_run():
    """One genome shard holds the whole (padded) chromosome and cold-starts:
    its trajectories are run_filter's + backward_simulation's on the unit's
    main-filter and round-1 generators, bit for bit, on the chromosome's
    rows, and its logZ the monolithic one."""
    params = _small_params()
    T, seg = 45, 16
    y, n = _counts(T, 5)
    M, B, seeds = 4, 5, [0, 2]
    traj, log_z = sharded_two_group_inference(
        make_mesh(1, 2, device="cpu"), params, y, n, y, n, segment_size=seg, buffer_size=3,
        num_resampled_ancestors=M, num_samples_backward=B, seeds=seeds, weight_dtype=F64, boundary="exchange")
    E_c, E_k = tsh.window_tables(params, (y, n, y, n), T, 3 * seg, None, 1)
    for i, s in enumerate(seeds):
        res = run_filter(params, E_c[0], E_k[0], M, n_units=1, weight_dtype=F64,
                         generator=tsh.unit_generator("cpu", tsh.FILTER, 0, 0, s))
        mono = backward_simulation(params, res.log_weights, res.particles, B,
                                   generator=tsh.unit_generator("cpu", tsh.BACKWARD, 0, 0, s))
        assert np.array_equal(traj[:T, i * B : (i + 1) * B], mono[0, :T].numpy()), s
        assert log_z[0, i] == float(res.log_normalizing_constant[0])


def test_padding_rows_score_zero():
    """The tables give zero-read rows f32 rounding (BetaBinomial) or a
    constant (robust: S (1/b - 1/(b+1)) a row); the windows' padding rows
    (outside the chromosome) are exactly 0 in both, and every other row is
    the table's."""
    from hygeia_tpu_torch.ops.emissions import emission_log_prob_table, robust_emission_log_prob_table

    params = tm.make_params(
        mu=(0.95, 0.05, 0.80, 0.20, 0.50, 0.50), sigma=(0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751),
        p_softmax_control=np.zeros((6, 6)), omega_logit_control=np.full(6, 2.0), omega_case=0.8,
        kappa_control=np.full(6, 2.0), kappa_case=np.full(6, 2.0), merge_log_prob=np.log(0.1),
        split_prob=0.01, minimum_duration=3, d_max=64, device="cpu")
    T, seg, buf = 30, 8, 3
    y, n = _counts(T, 9)
    zeros = np.zeros((1, 2), np.float32)
    assert not bool((robust_emission_log_prob_table(zeros, zeros + 0, params.alpha, params.beta, 0.05) == 0).all())
    yw, nw = (tsh.make_block_windows(a, seg, buf, 4) for a in (y, n))
    whole = emission_log_prob_table(y, n, params.alpha, params.beta)
    for robust_beta in (None, 0.05):
        E_c, _ = tsh.window_tables(params, (y, n, y, n), T, seg, buf, 4, robust_beta)
        for b in range(4):
            # One table a window (the robust support bound is the window's max(n)).
            table = (emission_log_prob_table(yw[b], nw[b], params.alpha, params.beta) if robust_beta is None else
                     robust_emission_log_prob_table(yw[b], nw[b], params.alpha, params.beta, robust_beta))
            for i in range(seg + 2 * buf):
                p = b * seg - buf + i
                inside = 0 <= p < T
                assert torch.equal(E_c[b, i], table[i] if inside else torch.zeros(6)), (robust_beta, b, i)
                if robust_beta is None and inside:
                    assert torch.equal(E_c[b, i], whole[p])


@pytest.mark.parametrize("boundary", ["halo", "exchange"])
@pytest.mark.parametrize("cap", [None, 3])
def test_launches_follow_the_formula(monkeypatch, boundary, cap):
    """The resampler's calls (the kernel's launches on a card) per chunk:
    halo (seg + 2 buf) - 1; exchange (W - 1) + window, plus the window again
    a chunk when the main filter re-runs (two chunks or more). The result
    does not depend on the chunks."""
    import hygeia_tpu_torch.two_group.filter as filt

    calls = []
    real = filt.optimal_resampling
    monkeypatch.setattr(filt, "optimal_resampling", lambda *a: calls.append(1) or real(*a))
    params = _small_params()
    y, n = _counts(64, 1)
    tim = {}
    out = sharded_two_group_inference(
        make_mesh(4, 2, device="cpu"), params, y, n, y, n, segment_size=8, buffer_size=3,
        num_resampled_ancestors=4, num_samples_backward=5, seeds=[0, 1], boundary=boundary,
        max_units_per_call=cap, timings=tim)
    units = 16 if boundary == "halo" else 8  # 8 blocks or 4 windows, x 2 seeds
    assert tim["chunks"] == [units] if cap is None else [3] * (units // 3) + [units % 3]
    # With chunks of 3 the exchange's last chunk holds only the last window's
    # units (whose round 1 stands), so two chunks re-run the main filter.
    reruns = 2 if boundary == "exchange" and cap else 0
    assert len(calls) == tsh.expected_launches(boundary, 8, 3, 2, len(tim["chunks"]), reruns)
    if cap is not None:
        ref = sharded_two_group_inference(
            make_mesh(4, 2, device="cpu"), params, y, n, y, n, segment_size=8, buffer_size=3,
            num_resampled_ancestors=4, num_samples_backward=5, seeds=[0, 1], boundary=boundary)
        assert np.array_equal(out[0], ref[0]) and np.array_equal(out[1], ref[1])
    assert tim["degenerate"].shape == out[1].shape


# The world-size tests' call (mesh 4x2, 64 sites at dry-run sizes), as
# source: the worker processes run it without importing JAX or this module.
def test_exchange_window_beyond_the_budget_raises(monkeypatch):
    """The exchange scheme holds a whole window's history: a window that
    alone exceeds the memory budget raises, naming its bytes, the budget
    and the cure (more genome shards); the halo scheme runs a unit a
    chunk."""
    monkeypatch.setenv("HYGEIA_HBM_BUDGET_GB", "1e-5")
    params = _small_params()
    y, n = _counts(64, 1)
    kw = dict(segment_size=16, buffer_size=4, num_resampled_ancestors=4, num_samples_backward=5, seeds=[0])
    with pytest.raises(MemoryError, match=r"window of 32 sites holds \d+ bytes.*budget of 10737 bytes.*genome shards"):
        sharded_two_group_inference(make_mesh(2, 1, device="cpu"), params, y, n, y, n, boundary="exchange", **kw)
    tim = {}
    sharded_two_group_inference(make_mesh(2, 1, device="cpu"), params, y, n, y, n, timings=tim, **kw)
    assert tim["chunks"] == [1] * 4


_WORLD_CASE = r"""
import numpy as np
from hygeia_tpu_torch.parallel import sharded_two_group_inference
from hygeia_tpu_torch.two_group.model import make_params


def world_case(mesh, boundary):
    params = make_params(
        mu=(0.9, 0.1, 0.7, 0.3), sigma=(0.05, 0.05, 0.1, 0.1), p_softmax_control=np.zeros((4, 4)),
        omega_logit_control=np.full(4, 2.0), omega_case=0.8, kappa_control=np.full(4, 2.0),
        kappa_case=np.full(4, 2.0), merge_log_prob=np.log(0.1), split_prob=0.01, minimum_duration=2,
        d_max=65, device="cpu")
    rng = np.random.default_rng(2)
    n = rng.poisson(15, size=(64, 2)).astype(np.float32)
    n[rng.random(64) < 0.1] = 0
    y = np.minimum(rng.poisson(6, size=(64, 2)), n).astype(np.float32)
    return sharded_two_group_inference(mesh, params, y, n, y, n, segment_size=16, buffer_size=4,
                                       num_resampled_ancestors=4, num_samples_backward=5, seeds=[0, 1],
                                       boundary=boundary)
"""

_WORKER = _WORLD_CASE + r"""
import sys
import torch
torch.set_num_threads(1)
from hygeia_tpu_torch.parallel.launcher import initialize_distributed
from hygeia_tpu_torch.parallel import make_mesh
from hygeia_tpu_torch.parallel.sharded import MESSAGES

rank, world = int(sys.argv[1]), int(sys.argv[2])
assert initialize_distributed(f"file://{sys.argv[3]}", world, rank, backend="gloo") == (rank, world)
out = {}
for boundary in ("halo", "exchange"):
    res = world_case(make_mesh(4, 2, device="cpu"), boundary)
    assert (res is None) == (rank != 0)
    if rank == 0:
        out[f"{boundary}_traj"], out[f"{boundary}_log_z"] = res
        out[f"{boundary}_calls"] = np.array([MESSAGES.rounds, MESSAGES.calls])
if rank == 0:
    np.savez(sys.argv[4], **out)
"""


def _run_world(tmp_path, world):
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    env.pop("RANK", None)
    rendezvous, result = tmp_path / f"rdv{world}", tmp_path / f"out{world}.npz"
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(world), str(rendezvous), str(result)],
                              cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-3000:]
    return dict(np.load(result))


def test_world_size_does_not_change_the_result(tmp_path):
    """2 and 4 gloo processes on the CPU, mesh 4x2, halo and exchange: rank
    0's trajectories and logZ equal the one-process run's bit for bit; the
    messages are the one-process run's, and the torch.distributed calls (one
    a message between ranks) are the same at worlds 2 and 4."""
    ns = {}
    exec(_WORLD_CASE, ns)
    ref = {}
    for boundary in ("halo", "exchange"):
        ref[boundary] = ns["world_case"](make_mesh(4, 2, device="cpu"), boundary)
        ref[f"{boundary}_rounds"] = tsh.MESSAGES.rounds
        assert tsh.MESSAGES.calls == 0
    runs = {w: _run_world(tmp_path, w) for w in (2, 4)}
    for w, got in runs.items():
        for boundary in ("halo", "exchange"):
            assert np.array_equal(got[f"{boundary}_traj"], ref[boundary][0]), (w, boundary)
            assert np.array_equal(got[f"{boundary}_log_z"], ref[boundary][1]), (w, boundary)
            rounds, calls = got[f"{boundary}_calls"]
            assert rounds == ref[f"{boundary}_rounds"] == calls, (w, boundary, rounds, calls)
    for boundary in ("halo", "exchange"):
        assert np.array_equal(runs[2][f"{boundary}_calls"], runs[4][f"{boundary}_calls"])
    assert ref["halo_rounds"] == 2 and ref["exchange_rounds"] == 5


@pytest.fixture(scope="module")
def sequential_run(tmp_path_factory):
    """tests/test_orchestrator.py's meshed-format fixture, run sequentially
    through the port's pipeline (theta, INFER, aggregate, DMPs)."""
    from hygeia_tpu_torch.pipeline.orchestrator import run_two_group
    from tests.test_orchestrator import _write_two_group_fixture

    root = tmp_path_factory.mktemp("meshed_pipeline")
    pre = _write_two_group_fixture(root)
    kw = dict(chroms=["cF"], preprocessed_dir=pre, segment_size=60, buffer_size=25, inference_seeds=(0, 1),
              num_resampled_particles=6, num_samples_backward=8, n_particles_single_group=30, max_retries=0,
              device="cpu")
    return root, run_two_group(output_dir=root / "seq", **kw), kw


@pytest.fixture(scope="module")
def meshed_run(sequential_run):
    """run_two_group(mesh_shape=(4, 2)) after the sequential run's theta."""
    import shutil

    from hygeia_tpu_torch.pipeline.orchestrator import run_two_group

    root, out_seq, kw = sequential_run
    shutil.copytree(out_seq / "2_ESTIMATE_PARAMETERS_AND_REGIMES", root / "mesh" / "2_ESTIMATE_PARAMETERS_AND_REGIMES")
    return run_two_group(output_dir=root / "mesh", mesh_shape=(4, 2), **kw)


def test_meshed_pipeline_writes_the_sequential_file_sets(sequential_run, meshed_run):
    """tests/test_orchestrator.py::test_meshed_infer_matches_sequential_format
    on the port: run_two_group(mesh_shape=(4, 2)) after the sequential run's
    theta writes the same file set per batch (split and regime archives
    trimmed to the segment), the same aggregate index and shapes and the
    same DMP columns; its flags files equal the JAX meshed runner's line
    for line on the same inputs."""
    from hygeia_tpu.two_group.runner import infer_chromosome_meshed as jax_meshed
    from hygeia_tpu_torch.utils import io as tio

    root, out_seq, kw = sequential_run
    out_mesh = meshed_run
    N = 6 * 48
    for b in range(3):
        seq_d, mesh_d = out_seq / "4_INFER" / f"chrom_cF_{b}", out_mesh / "4_INFER" / f"chrom_cF_{b}"
        names = sorted(p.name for p in seq_d.iterdir())
        assert names == sorted(p.name for p in mesh_d.iterdir()), b
        n_ret = 60 if b < 2 else 50
        for name in names:
            if name.endswith(".npz"):
                e, g = np.load(seq_d / name)["arr_0"], np.load(mesh_d / name)["arr_0"]
                assert g.dtype == e.dtype, name
                if "split_probs" in name or "regime_probs" in name:
                    assert g.shape[0] == n_ret and g.shape[1:] == e.shape[1:], name
                else:
                    assert g.shape == e.shape, name
        assert (mesh_d / f"optimal_backward_particles_merged_state_{N}_0.npz").exists()
    assert (out_mesh / "4_INFER" / "unit_cF_meshed" / ".done").exists()
    for name in ("control_regimes_chrom_cF.csv.gz", "split_probs_cF.csv.gz"):
        hs, ts = (tio._read_text(o / "5_AGGREGATE_RESULTS" / "cF" / name).decode() for o in (out_seq, out_mesh))
        index = lambda text: [r.replace("\t", ",").split(",")[0] for r in text.splitlines()]
        assert index(hs) == index(ts) and len(hs.splitlines()[1].split()) == len(ts.splitlines()[1].split()), name
    for name in ("dmp_0.05.csv", "weighted_dmp_0.05.csv"):
        seq_head = (out_seq / "6_GET_DMPS" / "cF" / name).read_text().splitlines()[0]
        assert (out_mesh / "6_GET_DMPS" / "cF" / name).read_text().splitlines()[0] == seq_head

    jax_dir = root / "jax_mesh"
    jax_meshed(data_dir=str(kw["preprocessed_dir"]), single_group_dir=str(out_seq / "2_ESTIMATE_PARAMETERS_AND_REGIMES" / "cF"),
               results_dir=str(jax_dir), chrom="cF", mesh_shape=(4, 2), seed=[0, 1], segment_size=60,
               buffer_size=25, minimum_duration=3, num_resampled_particles=(6,), num_samples_backward=8)
    for b in range(3):
        for s in (0, 1):
            got = (out_mesh / "4_INFER" / f"chrom_cF_{b}" / f"flags{s}.txt").read_text().splitlines()
            want = (jax_dir / f"chrom_cF_{b}" / f"flags{s}.txt").read_text().splitlines()
            assert got == want, (b, s)


_PIPELINE_WORKER = r"""
import json, sys
import torch
torch.set_num_threads(1)
from hygeia_tpu_torch.parallel.launcher import initialize_distributed
from hygeia_tpu_torch.pipeline.orchestrator import run_two_group

rank, rendezvous, kw = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
initialize_distributed(f"file://{rendezvous}", 2, rank, backend="gloo")
out = run_two_group(mesh_shape=(4, 2), **kw)
assert (out is None) == (rank != 0)
"""


def test_two_ranks_run_the_meshed_pipeline(tmp_path, sequential_run, meshed_run):
    """run_two_group(mesh_shape=(4, 2)) in two gloo processes: rank 0 runs
    the stages, rank 1 joins its meshed INFER; the INFER archives and logZ
    files equal the one-process meshed run's bit for bit, the DMP files
    byte for byte."""
    import json
    import shutil

    root, out_seq, kw = sequential_run
    out = tmp_path / "w2"
    shutil.copytree(out_seq / "2_ESTIMATE_PARAMETERS_AND_REGIMES", out / "2_ESTIMATE_PARAMETERS_AND_REGIMES")
    args = json.dumps({**kw, "preprocessed_dir": str(kw["preprocessed_dir"]), "output_dir": str(out)})
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", _PIPELINE_WORKER, str(r), str(tmp_path / "rdv"), args],
                              cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-3000:]
    for b in range(3):
        a_dir, b_dir = meshed_run / "4_INFER" / f"chrom_cF_{b}", out / "4_INFER" / f"chrom_cF_{b}"
        names = sorted(p.name for p in a_dir.iterdir())
        assert names == sorted(p.name for p in b_dir.iterdir())
        for name in names:
            if name.endswith(".npz"):
                assert np.array_equal(np.load(a_dir / name)["arr_0"], np.load(b_dir / name)["arr_0"]), name
            elif name.startswith("log_normalizing"):
                assert (a_dir / name).read_text() == (b_dir / name).read_text(), name
    for name in ("dmp_0.05.csv", "weighted_dmp_0.05.csv"):
        assert (out / "6_GET_DMPS" / "cF" / name).read_bytes() == (meshed_run / "6_GET_DMPS" / "cF" / name).read_bytes()


def test_robust_meshed_infer(tmp_path):
    """tests/test_robust_mode.py::test_robust_meshed_infer on the port at a
    small size (mesh 2x1, one seed, segment 100 + 10 on 200 CpGs, M = 6,
    B = 8): the standard file set per batch, the robust flag, and a logZ
    other than the BetaBinomial run's."""
    from hygeia_tpu_torch.two_group.runner import infer_chromosome_meshed
    from hygeia_tpu_torch.utils import io as tio
    from hygeia_tpu.single_group.model import parameters_to_theta

    R, T = 6, 200
    rng = np.random.default_rng(0)
    data, sg = tmp_path / "data", tmp_path / "sg"
    P = np.full((R, R), 1.0 / (R - 1))
    np.fill_diagonal(P, 0.0)
    tio.write_theta(sg / "theta_t.csv.gz", parameters_to_theta(P, np.full(R, 0.9)))
    n_c = rng.poisson(30, size=(T, 4))
    n_k = rng.poisson(30, size=(T, 4))
    tio.write_count_matrix(data / "positions_t.txt.gz", np.arange(1, T + 1) * 37)
    tio.write_count_matrix(data / "n_total_reads_control_t.txt.gz", n_c)
    tio.write_count_matrix(data / "n_total_reads_case_t.txt.gz", n_k)
    tio.write_count_matrix(data / "n_methylated_reads_control_t.txt.gz", rng.binomial(n_c, 0.8))
    tio.write_count_matrix(data / "n_methylated_reads_case_t.txt.gz", rng.binomial(n_k, 0.2))
    log_z = {}
    for robust in (True, False):
        results = tmp_path / f"results_{robust}"
        log_z[robust] = infer_chromosome_meshed(
            data_dir=str(data), single_group_dir=str(sg), results_dir=str(results), chrom="t", mesh_shape=(2, 1),
            device="cpu", seed=[0], segment_size=100, buffer_size=10, num_resampled_particles=(6,),
            num_samples_backward=8, robust=robust, robust_beta=0.05)
        n_bwd = 6 * (2 * R + R * R)
        for b in (0, 1):
            assert (results / f"chrom_t_{b}" / f"optimal_regime_probs_{n_bwd}_0.npz").exists()
            flags = (results / f"chrom_t_{b}" / "flags0.txt").read_text()
            assert f"--robust={robust}" in flags and "--mesh=2x1" in flags and "--boundary=halo" in flags
    assert np.isfinite(log_z[True][0][0][n_bwd]) and log_z[True][0][0][n_bwd] != log_z[False][0][0][n_bwd]


def test_per_unit_generators_draw_the_one_unit_draws():
    """filter._draw_uniforms and backward.gumbel with a list of generators:
    row u holds what a one-unit draw on generator u holds; the warm units of
    a use_init run draw, the cold ones take placeholders."""
    from hygeia_tpu_torch.two_group.backward import gumbel
    from hygeia_tpu_torch.two_group.filter import _draw_uniforms

    gens = lambda: [torch.Generator().manual_seed(s) for s in (4, 9, 1)]
    us, um = _draw_uniforms(gens(), 3, 5, "cpu")
    for u, g in enumerate(gens()):
        assert torch.equal(us[u : u + 1], torch.rand((1,), generator=g))
        assert torch.equal(um[u : u + 1], torch.rand((1, 5), generator=g))
    us, um = _draw_uniforms(gens(), 3, 5, "cpu", only=[True, False, True])
    assert float(us[1]) == 0.5 and torch.equal(us[2:], torch.rand((1,), generator=gens()[2]))
    noise = gumbel((3, 2, 7), generator=gens(), dtype=F64)
    for u, g in enumerate(gens()):
        assert torch.equal(noise[u : u + 1], gumbel((1, 2, 7), generator=g, dtype=F64))


@pytest.mark.parametrize("seed", [None, 0, 1])
def test_probe_plain_version_is_the_formula(seed):
    """The probe kernel's plain version, 2 * x + x.max(), equals the JAX
    probe's formula x * 2.0 + jnp.max(x) evaluated in jnp, bit for bit, on
    .round4/pallas_smoke.py's arange(1024).reshape(8, 128) and on seeded
    random blocks; on a CPU tensor the wrapper takes the plain version and
    counts no launch."""
    if seed is None:
        x = np.arange(8 * 128, dtype=np.float32).reshape(8, 128)
    else:
        x = (np.random.default_rng(seed).standard_normal((8, 128)) * 10).astype(np.float32)
    want = np.asarray(jnp.asarray(x) * 2.0 + jnp.max(jnp.asarray(x)))
    before = tprobe.PROBE.launches
    got = tprobe.probe(torch.from_numpy(x))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert tprobe.PROBE.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tprobe.probe_cuda(torch.from_numpy(x))
