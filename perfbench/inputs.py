"""The benchmark's seeded inputs: a methylation chromosome of two groups and
the theta file INFER reads.

One general generator reads a traffic file's parameters. The CpG positions
and the read depths follow hygeia's realistic fixture (a frozen copy of
``realistic_positions`` and ``realistic_coverage``: islands in a sea,
negative-binomial depth with dropout). The control regimes are runs of
geometric length drawn uniformly from the configuration's R regimes; a
site's methylation level is drawn from its regime's Beta law (mean mu,
sd sigma) and the methylated reads are binomial. In ``dmr_windows``
case-only windows of ``dmr_sites`` sites the case group flips between the
high (mu >= 0.5 becomes regime 1, the lowest) and low (becomes regime 0)
regimes, as hygeia's smoke test plants them.

Every draw comes from ``numpy.random.default_rng(seed)``: the same seed
gives the same chromosome, any seed the same sizes.
"""

from __future__ import annotations

import gzip
import math
import os

import numpy as np


def realistic_positions(rng, n_sites, *, island_rate=0.10, start=5_010_000):
    """CpG coordinates from a two-state (island/sea) Markov chain: island
    runs of ~35 CpGs at 2-50 bp gaps, sea runs of ~150 CpGs at lognormal
    ~100-2000 bp gaps. Returns (positions, island_mask)."""
    in_island = np.zeros(n_sites, bool)
    state = False
    i = 0
    while i < n_sites:
        if state:
            run = max(5, int(rng.geometric(1.0 / 35)))
        else:
            run = max(10, int(rng.geometric(1.0 / (35 / island_rate * (1 - island_rate)))))
        run = min(run, n_sites - i)
        in_island[i : i + run] = state
        i += run
        state = not state
    gaps = np.where(
        in_island,
        2 + rng.geometric(1.0 / 14, n_sites),
        np.maximum(20, rng.lognormal(np.log(300), 0.9, n_sites)).astype(np.int64),
    ).astype(np.int64)
    return start + np.cumsum(gaps), in_island


def realistic_coverage(rng, n_sites, n_samples, *, mean_depth=30.0, dispersion=3.0, missing_prob=0.55):
    """(T, S) total reads: negative-binomial depth with per-(site, sample)
    dropout; a missing site carries 0 reads."""
    p = dispersion / (dispersion + mean_depth)
    depth = rng.negative_binomial(dispersion, p, size=(n_sites, n_samples))
    miss = rng.random((n_sites, n_samples)) < missing_prob
    return np.where(miss, 0, np.maximum(depth, 1)).astype(np.float32)


def two_group_chromosome(traffic, config, seed):
    """{name: array} of one chromosome: positions (T,), and (T, S) int64
    n_total_reads_{control,case} and n_methylated_reads_{control,case}."""
    rng = np.random.default_rng(int(seed))
    T = int(traffic["chromosome_sites"])
    S = int(traffic["samples_per_group"])
    mu, sigma = np.asarray(config["mu"], np.float64), np.asarray(config["sigma"], np.float64)
    R = mu.size
    cov = dict(mean_depth=traffic["mean_depth"], dispersion=traffic["dispersion"],
               missing_prob=traffic["missing_prob"])
    positions, _ = realistic_positions(rng, T, island_rate=traffic["island_rate"])
    n_c = realistic_coverage(rng, T, S, **cov).astype(np.int64)
    n_k = realistic_coverage(rng, T, S, **cov).astype(np.int64)

    lengths = rng.geometric(1.0 / traffic["regime_run_mean"], size=T)
    regime = np.repeat(rng.integers(0, R, size=T), lengths)[:T]
    case_regime = regime.copy()
    span = int(traffic["dmr_sites"])
    candidates = np.arange(1000, T - span - 1000, 2 * span)
    n_dmr = min(int(traffic["dmr_windows"]), candidates.size)
    for s in rng.choice(candidates, n_dmr, replace=False):
        w = slice(s, s + span)
        case_regime[w] = np.where(mu[regime[w]] >= 0.5, 1, 0)

    nu = mu * (1 - mu) / sigma**2 - 1
    a, b = mu * nu, (1 - mu) * nu
    level_c = rng.beta(a[regime], b[regime])[:, None]
    level_k = rng.beta(a[case_regime], b[case_regime])[:, None]
    return {
        "positions": positions,
        "n_total_reads_control": n_c,
        "n_methylated_reads_control": rng.binomial(n_c, np.broadcast_to(level_c, n_c.shape)),
        "n_total_reads_case": n_k,
        "n_methylated_reads_case": rng.binomial(n_k, np.broadcast_to(level_k, n_k.shape)),
    }


def write_int_csv_gz(path, arr):
    """A header-less comma-separated integer table, gzip level 1 (the
    preprocessed count files INFER reads)."""
    a = np.asarray(arr, np.int64)
    a = a[:, None] if a.ndim == 1 else a
    body = "\n".join(",".join(map(str, row)) for row in a.tolist()) + "\n"
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(body.encode())


def write_chromosome(data_dir, chrom, arrays):
    os.makedirs(data_dir, exist_ok=True)
    for name, arr in arrays.items():
        write_int_csv_gz(os.path.join(data_dir, f"{name}_{chrom}.txt.gz"), arr)


def theta_vector(config):
    """The packed theta of the configuration's P and omega: log P's R(R-1)
    off-diagonal entries row-major, then logit(omega)."""
    P = np.asarray(config["theta"]["p"], np.float64)
    omega = np.asarray(config["theta"]["omega"], np.float64)
    off = [math.log(P[r, c]) for r in range(P.shape[0]) for c in range(P.shape[0]) if c != r]
    return np.concatenate([off, np.log(omega) - np.log1p(-omega)])


def write_theta(path, theta):
    """The single-group stage's theta file: a headed CSV of one ``data``
    column, gzipped."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(("data\n" + "".join(f"{float(v)!r}\n" for v in theta)).encode())


def log_p_of_theta(theta, R):
    """(log P with a -inf diagonal, omega) of a packed theta: each row's
    off-diagonal entries exponentiated and renormalised."""
    theta = np.asarray(theta, np.float64)
    P = np.zeros((R, R))
    mask = ~np.eye(R, dtype=bool)
    P[mask] = np.exp(theta[: R * (R - 1)])
    P /= P.sum(1, keepdims=True)
    with np.errstate(divide="ignore"):
        return np.log(P), 1.0 / (1.0 + np.exp(-theta[R * (R - 1):]))
