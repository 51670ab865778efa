"""The DMP sets end to end against the JAX package: one theta file and one
fixture (the JAX package's ``make_realistic_fixture``: 2,000 CpGs with
islands, missingness and overdispersed depth, two samples a group), each
package's ``infer`` (seeds 0 and 1), ``aggregate`` and ``get_dmps`` verbs.

Realisations differ (threefry keys against torch generators), so the port
is held to the JAX package within what the JAX package differs from
itself: the JAX run of seeds (2, 3), aggregated as seeds (0, 1), against
its run of seeds (0, 1) gives a distance d for each quantity, and the
port's distance to the JAX seeds-(0, 1) run must be at most 1.5 d. The
quantities: the mean absolute difference of the aggregated split
probabilities, and the Jaccard distance of the DMP positions at FDR 0.05
(plain and weighted)."""

import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from hygeia_tpu.cli import main as jax_cli
from hygeia_tpu.single_group.model import parameters_to_theta
from hygeia_tpu.two_group.realistic import make_realistic_fixture
from hygeia_tpu.two_group.runner import infer_segment as jax_infer_segment
from hygeia_tpu.utils import io as hio
from hygeia_tpu_torch import cli as torch_cli

torch.set_num_threads(1)

CHROM, T, SEG, M, B = "e", 2_000, 2_500, 8, 25
R = 6
N = M * (2 * R + R * R)
BOUND = 1.5


def _split(agg):
    lines = gzip.decompress((agg / f"split_probs_{CHROM}.csv.gz").read_bytes()).decode().splitlines()[1:]
    return np.array([[float(x) for x in ln.split("\t")[1:]] for ln in lines]).mean(axis=1)


def _dmps(dmp, name):
    lines = (dmp / name).read_text().splitlines()[1:]
    return {int(ln.split(",")[1]) for ln in lines}


def _jaccard(a, b):
    return 1.0 - len(a & b) / max(len(a | b), 1)


def _aggregate_and_call(cli, results, out):
    agg, dmp = out / "agg", out / "dmp"
    cli(["aggregate", "--results_dir", str(results), "--output_dir", str(agg), "--seeds", "2", "--chrom", CHROM,
         "--num_batches", "1", "--num_particles", str(N)])
    cli(["get_dmps", "--results_dir", str(agg), "--output_dir", str(dmp), "--chrom", CHROM])
    return {"split": _split(agg), **{n: _dmps(dmp, n) for n in ("dmp_0.05.csv", "weighted_dmp_0.05.csv")}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e")
    data, sg = root / "data", root / "sg"
    fx = make_realistic_fixture(data, CHROM, T, n_samples=2, seed=1)
    P = np.random.default_rng(2).dirichlet(np.ones(R - 1), size=R)
    Pf = np.zeros((R, R))
    for r in range(R):
        Pf[r, [c for c in range(R) if c != r]] = P[r]
    sg.mkdir()
    hio.write_theta(sg / f"theta_{CHROM}.csv.gz", parameters_to_theta(Pf, np.full(R, 0.9)))
    common = dict(data_dir=str(data), single_group_dir=str(sg), chrom=CHROM, segment_size=SEG, buffer_size=0)

    # JAX: seeds 0-3 in one call; seeds 2 and 3 copied under the names of 0 and 1.
    jax_infer_segment(results_dir=str(root / "jax"), seed=(0, 1, 2, 3), num_resampled_particles=(M,),
                      num_samples_backward=B, **common)
    src, alt = root / "jax" / f"chrom_{CHROM}_0", root / "jax_alt" / f"chrom_{CHROM}_0"
    alt.mkdir(parents=True)
    for name in os.listdir(src):
        for s_from, s_to in (("_2.npz", "_0.npz"), ("_3.npz", "_1.npz")):
            if name.endswith(s_from):
                shutil.copy(src / name, alt / (name[: -len(s_from)] + s_to))
        if name.endswith(".csv.gz"):
            shutil.copy(src / name, alt / name)
    for seed in (0, 1):
        torch_cli.main(["infer", "--data_dir", str(data), "--single_group_dir", str(sg),
                        "--results_dir", str(root / "torch"), "--chrom", CHROM, "--segment_size", str(SEG),
                        "--buffer_size", "0", "--seed", str(seed), "--num_resampled_particles", str(M),
                        "--num_samples_backward", str(B), "--device", "cpu"])
    return {
        "fixture": fx,
        "jax": _aggregate_and_call(jax_cli, root / "jax", root / "out_jax"),
        "jax_alt": _aggregate_and_call(jax_cli, root / "jax_alt", root / "out_jax_alt"),
        "torch": _aggregate_and_call(torch_cli.main, root / "torch", root / "out_torch"),
    }


def test_split_probabilities_within_the_jax_seed_spread(runs):
    ref = runs["jax"]["split"]
    assert ref.shape == runs["torch"]["split"].shape == (T,)
    d_jax = np.abs(runs["jax_alt"]["split"] - ref).mean()
    d_torch = np.abs(runs["torch"]["split"] - ref).mean()
    assert d_torch <= BOUND * d_jax, (d_torch, d_jax)
    # The split signal is there: higher where the simulated case split off.
    split_sites = runs["fixture"].states[:, 0] == 0
    assert runs["torch"]["split"][split_sites].mean() > runs["torch"]["split"][~split_sites].mean() + 0.2


@pytest.mark.parametrize("name", ["dmp_0.05.csv", "weighted_dmp_0.05.csv"])
def test_dmp_sets_within_the_jax_seed_spread(runs, name):
    ref = runs["jax"][name]
    assert len(ref) > 10 and len(runs["torch"][name]) > 10
    d_jax = _jaccard(runs["jax_alt"][name], ref)
    d_torch = _jaccard(runs["torch"][name], ref)
    assert d_torch <= BOUND * d_jax, (d_torch, d_jax, len(ref), len(runs["torch"][name]))
