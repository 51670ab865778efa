"""Robust mode (``infer --robust``): the port's beta-divergence emission
table (ops/emissions.robust_emission_log_prob_table) against the JAX
package's, and its wiring through the monolithic, streamed and
chromosome-wide INFER paths.

Tolerances: the table at f64 rtol 1e-12 (the two packages' lgamma and
log-sum-exp round differently in the last bits; measured 2e-15); at f32
against JAX's f32 table atol 1e-4 on values of 25-60 (measured 3.8e-5:
each rounds ~15 f32 operations a term) and against the f64 table rtol 1e-5
(measured 8.8e-7). At every chunk size the table is the same bit for bit.
"""

import gzip
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hygeia_tpu.ops.emissions import robust_emission_log_prob_table as j_robust
from hygeia_tpu.two_group.runner import infer_segment as jax_infer_segment
from hygeia_tpu_torch import cli as torch_cli
from hygeia_tpu_torch.ops.distributions import mu_sigma_to_alpha_beta
from hygeia_tpu_torch.ops.emissions import robust_emission_log_prob_table as t_robust
from hygeia_tpu_torch.two_group.runner import infer_chromosome_streamed, infer_segment
from tests.test_torch_streaming import BB, MM, MU, NN, SIGMA, _same_files, _write_chromosome

torch.set_num_threads(1)

F64 = torch.float64
R6_MU = np.array([0.95, 0.05, 0.8, 0.2, 0.5, 0.5])
R6_SIGMA = np.array([0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751])


def _counts(T=300, S=3, seed=0):
    """Poisson(20) depth with zero-coverage sites (a whole site, one sample)
    and one site much deeper than the rest, which sets max(n)."""
    rng = np.random.default_rng(seed)
    n = rng.poisson(20, size=(T, S)).astype(np.float64)
    n[5] = 0
    n[7, 1] = 0
    n[9, 0] = 61
    y = rng.binomial(n.astype(int), rng.uniform(0.05, 0.95, size=(T, 1))).astype(np.float64)
    y[9, 0] = 61  # y = n at the deepest site: x = n lies outside the support sum
    return y, n


def _ab(dtype=F64):
    a, b = mu_sigma_to_alpha_beta(torch.tensor(R6_MU, dtype=dtype), torch.tensor(R6_SIGMA, dtype=dtype))
    return a, b


@pytest.mark.parametrize("beta_div,atol", [(0.05, 0.0), (0.3, 1e-12)])
def test_robust_table_matches_jax_f64(beta_div, atol):
    """At beta 0.3 some scores lie near 0 (the two terms cancel), where the
    last bits of terms of ~3 are a large relative error: atol 1e-12 there
    (measured 5.6e-14)."""
    y, n = _counts()
    a, b = _ab()
    want = np.asarray(j_robust(y, n, a.numpy(), b.numpy(), beta_div, dtype=jnp.float64))
    got = t_robust(y, n, a, b, beta_div, dtype=F64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=atol)


def test_robust_table_f32():
    y, n = _counts(seed=1)
    a32, b32 = _ab(torch.float32)
    want32 = np.asarray(j_robust(y, n, a32.numpy(), b32.numpy()))
    a, b = _ab()
    want64 = np.asarray(j_robust(y, n, a.numpy(), b.numpy(), dtype=jnp.float64))
    got = t_robust(y, n, a32, b32).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want32, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, want64, rtol=1e-5, atol=0)


def test_robust_support_sum_stops_below_max_n():
    """The support sum runs over x < max(n) of the whole table: a table of
    the shallow sites alone differs from their rows in the whole table,
    both in JAX and in the port, and a chunk of shallow sites inside a
    chunked build keeps the whole table's bound."""
    y, n = _counts(seed=2)
    a, b = _ab()
    whole = t_robust(y, n, a, b, dtype=F64)
    shallow = t_robust(y[10:], n[10:], a, b, dtype=F64)
    assert not torch.allclose(whole[10:], shallow, rtol=1e-6)
    np.testing.assert_allclose(shallow.numpy(),
                               np.asarray(j_robust(y[10:], n[10:], a.numpy(), b.numpy(), dtype=jnp.float64)),
                               rtol=1e-12)
    # All-zero coverage: X = max(max(n), 1) = 1, the score of x = 0 alone.
    z = np.zeros((4, 2))
    np.testing.assert_allclose(t_robust(z, z, a, b, dtype=F64).numpy(),
                               np.asarray(j_robust(z, z, a.numpy(), b.numpy(), dtype=jnp.float64)), rtol=1e-12)


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_robust_table_equal_at_every_chunk_size(dtype):
    y, n = _counts(T=257, seed=3)
    a, b = _ab(dtype)
    ref = t_robust(y, n, a, b, dtype=dtype)
    X, S, R = int(n.max()), n.shape[1], 6
    for sites in (1, 2, 7, 64, 256, 1000):
        got = t_robust(y, n, a, b, dtype=dtype, chunk_elements=sites * X * S * R)
        assert torch.equal(got, ref), sites


# ------------------------------------------------------------- the paths ----

@pytest.fixture(scope="module")
def robust_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("robust")
    data, sg = _write_chromosome(root, "s", 90, 3)
    common = dict(data_dir=str(data), single_group_dir=str(sg), chrom="s", batch=0, segment_size=80,
                  buffer_size=10, mu=MU, sigma=SIGMA, num_resampled_particles=(MM,), num_samples_backward=BB)
    jax_infer_segment(results_dir=str(root / "jax"), seed=[0], robust=True, **common)
    torch_cli.main(["infer", "--data_dir", str(data), "--single_group_dir", str(sg), "--chrom", "s",
                    "--segment_size", "80", "--buffer_size", "10", "--mu", ",".join(map(str, MU)),
                    "--sigma", ",".join(map(str, SIGMA)), "--num_resampled_particles", str(MM),
                    "--num_samples_backward", str(BB), "--seed", "0", "--robust",
                    "--results_dir", str(root / "cli"), "--device", "cpu"])
    log_z = {
        "plain": infer_segment(results_dir=str(root / "plain"), seed=0, device="cpu", **common),
        "mono": infer_segment(results_dir=str(root / "mono"), seed=0, device="cpu", robust=True, **common),
        "stream": infer_segment(results_dir=str(root / "stream"), seed=0, device="cpu", robust=True,
                                streaming_blocks=32, **common),
    }
    return {k: root / k / "chrom_s_0" for k in ("jax", "cli", "mono", "stream", "plain")} | {"log_z": log_z}


def test_infer_robust_writes_the_jax_file_set(robust_runs):
    jx, cli = robust_runs["jax"], robust_runs["cli"]
    assert sorted(os.listdir(jx)) == sorted(os.listdir(cli))
    for name in os.listdir(jx):
        if name.endswith(".npz"):
            a, b = np.load(jx / name)["arr_0"], np.load(cli / name)["arr_0"]
            assert (a.shape, a.dtype) == (b.shape, b.dtype), name
        elif name.startswith("flags"):
            assert (jx / name).read_text() == (cli / name).read_text()
            assert "--robust=True" in (cli / name).read_text()
        elif name.endswith(".csv.gz"):
            assert gzip.decompress((jx / name).read_bytes()) == gzip.decompress((cli / name).read_bytes())
    _same_files(robust_runs["mono"], cli, skip=("optimal_time",))
    lz = robust_runs["log_z"]
    assert np.isfinite(lz["mono"][NN]) and lz["mono"][NN] != lz["plain"][NN]


def test_robust_streamed_writes_the_monolithic_arrays(robust_runs):
    mono, stream = robust_runs["mono"], robust_runs["stream"]
    for name in sorted(os.listdir(mono)):
        if name.endswith(".npz"):
            np.testing.assert_array_equal(np.load(mono / name)["arr_0"], np.load(stream / name)["arr_0"])
    lz = robust_runs["log_z"]
    assert lz["stream"][NN] == lz["mono"][NN]


def test_robust_chromosome_streamed_equals_per_segment_runs(tmp_path):
    """Three batches (windows of 80, 90 and 70 sites), seeds (0, 1), one
    unit a call: every file but the timings is that of
    infer_segment(robust=True, streaming_blocks=W) on its (batch, seed),
    whose table is built on its own window as the chromosome path builds
    each unit's rows."""
    data, sg = _write_chromosome(tmp_path, "c", 200, 9)
    common = dict(data_dir=str(data), single_group_dir=str(sg), chrom="c", segment_size=70, buffer_size=10,
                  mu=MU, sigma=SIGMA, num_resampled_particles=(MM,), num_samples_backward=BB,
                  streaming_blocks=32, device="cpu", robust=True)
    infer_chromosome_streamed(results_dir=str(tmp_path / "one"), seed=[0, 1], max_units_per_call=1, **common)
    for batch in range(3):
        for s in (0, 1):
            infer_segment(results_dir=str(tmp_path / f"seg{s}"), batch=batch, seed=s, **common)
            a, b = tmp_path / "one" / f"chrom_c_{batch}", tmp_path / f"seg{s}" / f"chrom_c_{batch}"
            for name in os.listdir(b):
                if name.startswith("optimal_time") or not (name.endswith(f"_{s}.npz") or name.endswith(f"{s}.txt")):
                    continue
                if name.endswith(".npz"):
                    np.testing.assert_array_equal(np.load(a / name)["arr_0"], np.load(b / name)["arr_0"])
                else:
                    assert (a / name).read_text() == (b / name).read_text(), name
