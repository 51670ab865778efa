"""The port's ``infer`` verb against the JAX package's on the same files.

Fixture: the tests/test_pipeline.py shape (a 260-site chromosome made with
numpy, R=6, 2 samples a group, reference-format inputs written by the JAX
package's writers); segment
150 + halo 30 (T=180 sites), M=12 (N=576), B=400, seeds 0-3. The JAX runner
runs the 4 seeds in one call; the port runs seed 0 through its CLI with
``--device cpu`` and seeds 1-3 as one batched call.

Realisations differ (threefry keys against torch.Generator streams), so the
sampled outputs are compared within a Monte-Carlo tolerance measured from
the between-seed spread: per site |mean_jax - mean_port| <= 4 se + 0.02,
se = sqrt(s_jax^2/4 + s_port^2/4) over the 4 seeds (ddof 1); the 0.02 floor
covers sites where one package's 4 seeds happen to agree exactly (B=400
draws give a binomial sd of 0.005 at p = 0.01).
"""

import gzip
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hygeia_tpu.single_group.model import parameters_to_theta
from hygeia_tpu.two_group.runner import infer_segment as jax_infer_segment
from hygeia_tpu.utils import io as hio
from hygeia_tpu_torch import cli as torch_cli
from hygeia_tpu_torch.two_group.runner import infer_segment as torch_infer_segment
from hygeia_tpu_torch.utils import io as tio

# The tensors here are small: one intra-op thread per test worker keeps the
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
R = 6
MU = [0.95, 0.05, 0.80, 0.20, 0.50, 0.50]
SIGMA = [0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751]
SEG, BUF, M, B = 150, 30, 12, 400
N = M * (2 * R + R * R)
SEEDS = (0, 1, 2, 3)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_infer")
    data_dir, sg_dir = root / "data", root / "single_group"
    data_dir.mkdir()
    sg_dir.mkdir()
    rng = np.random.default_rng(0)
    P = rng.dirichlet(np.ones(R - 1), size=R)
    Pfull = np.zeros((R, R))
    for r in range(R):
        Pfull[r, [c for c in range(R) if c != r]] = P[r]
    hio.write_theta(sg_dir / "theta_t.csv.gz", parameters_to_theta(Pfull, np.full(R, 0.9)))
    # Piecewise-constant regimes from the chain P (mean run 30 sites), a
    # case group that departs from the control in two windows, Beta levels
    # from the default mu/sigma, binomial reads.
    T, S = 260, 2
    regime = np.zeros(T, int)
    regime[0] = rng.integers(R)
    for t in range(1, T):
        regime[t] = rng.choice(R, p=Pfull[regime[t - 1]]) if rng.random() < 1 / 30 else regime[t - 1]
    case_regime = regime.copy()
    case_regime[40:90] = (regime[40:90] + 1) % R
    case_regime[150:200] = (regime[150:200] + 3) % R
    mu, sd = np.asarray(MU), np.asarray(SIGMA)
    nu = mu * (1 - mu) / sd**2 - 1
    n_c = rng.poisson(30, size=(T, S)).astype(np.float64)
    n_k = rng.poisson(30, size=(T, S)).astype(np.float64)
    y_c = rng.binomial(n_c.astype(int), rng.beta(mu[regime] * nu[regime], (1 - mu[regime]) * nu[regime])[:, None])
    y_k = rng.binomial(n_k.astype(int), rng.beta(mu[case_regime] * nu[case_regime], (1 - mu[case_regime]) * nu[case_regime])[:, None])
    hio.write_count_matrix(data_dir / "positions_t.txt.gz", np.arange(1, T + 1) * 50)
    hio.write_count_matrix(data_dir / "n_total_reads_control_t.txt.gz", n_c)
    hio.write_count_matrix(data_dir / "n_total_reads_case_t.txt.gz", n_k)
    hio.write_count_matrix(data_dir / "n_methylated_reads_control_t.txt.gz", y_c.astype(np.float64))
    hio.write_count_matrix(data_dir / "n_methylated_reads_case_t.txt.gz", y_k.astype(np.float64))

    common = dict(chrom="t", batch=0, segment_size=SEG, buffer_size=BUF)
    jax_dir, torch_dir = root / "jax", root / "torch"
    jax_log_z = jax_infer_segment(
        data_dir=str(data_dir), single_group_dir=str(sg_dir), results_dir=str(jax_dir),
        seed=SEEDS, num_resampled_particles=(M,), num_samples_backward=B, **common,
    )
    # Seed 0 through the CLI, as users run it; seeds 1-3 in one batched
    # call (one unit per seed), which writes the same files per seed.
    torch_log_z = {0: torch_cli.main([
        "infer", "--data_dir", str(data_dir), "--single_group_dir", str(sg_dir),
        "--results_dir", str(torch_dir), "--chrom", "t", "--batch", "0",
        "--segment_size", str(SEG), "--buffer_size", str(BUF), "--seed", "0",
        "--num_resampled_particles", str(M), "--num_samples_backward", str(B),
        "--device", "cpu",
    ])}
    torch_log_z.update(torch_infer_segment(
        data_dir=str(data_dir), single_group_dir=str(sg_dir), results_dir=str(torch_dir),
        seed=SEEDS[1:], num_resampled_particles=(M,), num_samples_backward=B, device="cpu", **common,
    ))
    return {
        "root": root, "data": data_dir, "sg": sg_dir,
        "jax": jax_dir / "chrom_t_0", "torch": torch_dir / "chrom_t_0",
        "jax_log_z": jax_log_z, "torch_log_z": torch_log_z,
    }


def test_same_file_set_and_shapes(runs):
    jax_files = sorted(os.listdir(runs["jax"]))
    assert jax_files == sorted(os.listdir(runs["torch"]))
    assert len(jax_files) == 5 + 9 * len(SEEDS)
    for name in jax_files:
        if name.endswith(".npz"):
            a = np.load(runs["jax"] / name)["arr_0"]
            b = np.load(runs["torch"] / name)["arr_0"]
            assert (a.shape, a.dtype) == (b.shape, b.dtype), name
    traj = np.load(runs["torch"] / f"optimal_backward_particles_control_state_{N}_0.npz")["arr_0"]
    assert traj.shape == (SEG, B, 2)


def test_trimmed_inputs_identical_after_decompression(runs):
    for name in ("observations_control", "observations_case", "n_total_reads_control",
                 "n_total_reads_case", "positions"):
        with gzip.open(runs["jax"] / f"{name}.csv.gz", "rb") as f:
            a = f.read()
        with gzip.open(runs["torch"] / f"{name}.csv.gz", "rb") as f:
            b = f.read()
        assert a == b, name


def test_flags_files_identical(runs):
    for s in SEEDS:
        a = (runs["jax"] / f"flags{s}.txt").read_text()
        b = (runs["torch"] / f"flags{s}.txt").read_text()
        assert a == b


def _per_seed(d, name):
    return np.stack([np.load(d / f"{name}_{N}_{s}.npz")["arr_0"] for s in SEEDS])


@pytest.mark.parametrize("name", ["optimal_split_probs", "optimal_regime_probs"])
def test_smoothing_outputs_agree_within_monte_carlo_tolerance(runs, name):
    a = _per_seed(runs["jax"], name)
    b = _per_seed(runs["torch"], name)
    assert a.shape == b.shape and np.all(np.isfinite(b))
    n = len(SEEDS)
    se = np.sqrt(a.var(axis=0, ddof=1) / n + b.var(axis=0, ddof=1) / n)
    diff = np.abs(a.mean(axis=0) - b.mean(axis=0))
    bad = diff > 4 * se + 0.02
    assert not bad.any(), (np.argwhere(bad)[:5], diff[bad][:5], se[bad][:5])


def test_log_z_agrees_within_seed_spread(runs):
    a = np.array([runs["jax_log_z"][s][N] for s in SEEDS])
    b = np.array([runs["torch_log_z"][s][N] for s in SEEDS])
    assert np.all(np.isfinite(b))
    se = np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
    assert abs(a.mean() - b.mean()) <= 4 * se + 1.0, (a, b)
    # The logZ file holds the value the CLI returned.
    text = (runs["torch"] / "log_normalizing_constants_optimal_0.txt").read_text().strip()
    assert text == str({N: float(b[0])})


def test_port_reads_and_writes_like_the_jax_io(runs, tmp_path):
    """The port's numpy+gzip io against hygeia_tpu.utils.io on the fixture
    files: same arrays read; integer tables written to the same bytes."""
    for name in ("positions_t", "n_total_reads_control_t", "n_methylated_reads_case_t"):
        p = runs["data"] / f"{name}.txt.gz"
        np.testing.assert_array_equal(tio.read_count_matrix(p), hio.read_count_matrix(p))
    np.testing.assert_array_equal(
        tio.read_positions(runs["data"] / "positions_t.txt.gz"),
        hio.read_positions(runs["data"] / "positions_t.txt.gz"),
    )
    # pandas' default float parser is not correctly rounded (1 ulp off at
    # times); the port parses the written shortest repr exactly.
    np.testing.assert_allclose(tio.read_theta(runs["sg"] / "theta_t.csv.gz"),
                               hio.read_theta(runs["sg"] / "theta_t.csv.gz"), rtol=1e-15)
    theta = np.random.default_rng(2).normal(size=36)
    tio.write_theta(tmp_path / "theta.csv.gz", theta)
    np.testing.assert_array_equal(tio.read_theta(tmp_path / "theta.csv.gz"), theta)
    np.testing.assert_allclose(hio.read_theta(tmp_path / "theta.csv.gz"), theta, rtol=1e-15)
    arr = np.random.default_rng(3).integers(-5, 70000, size=(50, 3))
    hio.write_count_matrix(tmp_path / "a.csv.gz", arr)
    tio.write_count_matrix(tmp_path / "b.csv.gz", arr)
    with gzip.open(tmp_path / "a.csv.gz") as fa, gzip.open(tmp_path / "b.csv.gz") as fb:
        assert fa.read() == fb.read()


def test_port_cli_imports_neither_jax_nor_pandas():
    code = (
        "import sys; import hygeia_tpu_torch.cli, hygeia_tpu_torch.two_group.runner; "
        "bad = [m for m in ('jax', 'pandas', 'hygeia_tpu') if m in sys.modules]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_device_cuda_raises_without_cuda(runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_cli.main([
            "infer", "--data_dir", str(runs["data"]), "--single_group_dir", str(runs["sg"]),
            "--results_dir", str(tmp_path), "--chrom", "t", "--segment_size", str(SEG),
            "--buffer_size", str(BUF), "--device", "cuda",
        ])
    assert not any(tmp_path.iterdir())  # raised before writing anything


# --streaming_blocks, --robust and --marginal are ported; --trace_dir, with
# them or alone, still raises.
@pytest.mark.parametrize("flag", [["--robust", "--marginal", "--trace_dir", "x"], ["--marginal", "--trace_dir", "x"],
                                  ["--streaming_blocks", "64", "--robust", "--trace_dir", "x"],
                                  ["--trace_dir", "x"]])
def test_unported_options_raise(runs, tmp_path, flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_cli.main([
            "infer", "--data_dir", str(runs["data"]), "--single_group_dir", str(runs["sg"]),
            "--results_dir", str(tmp_path), "--chrom", "t", "--device", "cpu", *flag,
        ])


def test_headed_csv_io_reads_and_writes_like_pandas(tmp_path):
    """The single-group engine's headed CSVs: the port's writers read back
    by hygeia_tpu.utils.io (pandas) and the other way round, plain and
    gzipped."""
    rng = np.random.default_rng(4)
    counts = rng.integers(0, 60, size=(2, 30))
    for suffix in (".csv", ".csv.gz"):
        tio.write_headed_matrix(tmp_path / f"t{suffix}", counts, "sample")
        np.testing.assert_array_equal(hio.read_headed_matrix(tmp_path / f"t{suffix}"), counts)
        hio.write_headed_matrix(tmp_path / f"j{suffix}", counts, "sample")
        np.testing.assert_array_equal(tio.read_headed_matrix(tmp_path / f"j{suffix}"), counts)
    probs = rng.dirichlet(np.ones(6), size=30).astype(np.float32)
    tio.write_headed_table(tmp_path / "p.csv", probs, [f"regime_{i + 1}" for i in range(6)],
                           first=("genomic_position", np.arange(30) * 7))
    import pandas as pd

    df = pd.read_csv(tmp_path / "p.csv")
    assert list(df.columns) == ["genomic_position"] + [f"regime_{i + 1}" for i in range(6)]
    np.testing.assert_array_equal(df["genomic_position"].to_numpy(), np.arange(30) * 7)
    np.testing.assert_array_equal(df.iloc[:, 1:].to_numpy(np.float32), probs)
    pos = rng.integers(1, 10**8, 30)
    hio.write_headed_column(tmp_path / "pos.csv", pos, "genomic_positions")
    np.testing.assert_array_equal(tio.read_headed_column(tmp_path / "pos.csv"), pos)
