"""Realistically shaped chromosome fixtures: non-uniform CpG spacing (islands
in a sea), per-sample missingness and overdispersed coverage, with the
methylation states drawn from the two-group model itself.

Counterpart of hygeia_tpu/two_group/realistic.py. ``realistic_positions``
and ``realistic_coverage`` are copies (numpy, the same draws from the same
``np.random.Generator``), so positions, island mask and coverage are the
JAX package's bit for bit; ``make_realistic_fixture`` simulates the states
and counts with two_group/simulate.py on ``device`` (another realisation
than the JAX package's threefry draws) and writes the preprocessed
count-file set with utils/io.py.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from hygeia_tpu_torch.two_group.model import make_params
from hygeia_tpu_torch.two_group.simulate import simulate
from hygeia_tpu_torch.two_group.simulate_runner import logit_f32
from hygeia_tpu_torch.utils import io as hio


class RealisticFixture(NamedTuple):
    positions: np.ndarray  # (T,) int64 genomic coordinates
    states: np.ndarray  # (T, 5) int32 true (m, d_c, r_c, d_k, r_k)
    island_mask: np.ndarray  # (T,) bool: the site lies in a CpG island
    n_total_control: np.ndarray  # (T, S) float32 (0 where missing)
    n_total_case: np.ndarray


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
    dropout; a missing site carries 0 reads, the imputed-row convention of
    preprocessing."""
    p = dispersion / (dispersion + mean_depth)
    depth = rng.negative_binomial(dispersion, p, size=(n_sites, n_samples))
    miss = rng.random((n_sites, n_samples)) < missing_prob
    return np.where(miss, 0, np.maximum(depth, 1)).astype(np.float32)


def make_realistic_fixture(
    out_dir,
    chrom,
    n_sites,
    *,
    device,
    n_samples=2,
    seed=0,
    mean_depth=30.0,
    missing_prob=0.55,
    mu=(0.95, 0.05, 0.80, 0.20, 0.50, 0.50),
    sigma=(0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751),
    omega=0.9,
    omega_case=0.8,
    minimum_duration=3,
    merge_log_prob=None,
    split_prob=0.01,
) -> RealisticFixture:
    """Simulate a realistically shaped chromosome on ``device`` and write the
    preprocessed count files (positions, n_total and n_methylated reads of
    control and case) under ``out_dir``. The chain and counts are drawn
    from a ``torch.Generator`` on ``device`` seeded with ``seed``."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    R = len(mu)
    merge_log_prob = np.log(0.1) if merge_log_prob is None else merge_log_prob

    positions, island = realistic_positions(rng, n_sites)
    n_c = realistic_coverage(rng, n_sites, n_samples, mean_depth=mean_depth, missing_prob=missing_prob)
    n_k = realistic_coverage(rng, n_sites, n_samples, mean_depth=mean_depth, missing_prob=missing_prob)

    Pd = rng.dirichlet(np.ones(R - 1), size=R)
    P = np.zeros((R, R))
    for r in range(R):
        P[r, [c for c in range(R) if c != r]] = Pd[r]
    with np.errstate(divide="ignore"):
        log_p = np.log(P)
    params = make_params(
        mu=mu,
        sigma=sigma,
        p_softmax_control=log_p,
        omega_logit_control=logit_f32(omega, R),
        omega_case=omega_case,
        kappa_control=np.full(R, 2.0),
        kappa_case=np.full(R, 2.0),
        merge_log_prob=merge_log_prob,
        split_prob=split_prob,
        minimum_duration=minimum_duration,
        d_max=n_sites + 2,
        device=device,
    )
    sim = simulate(params, n_c, n_k, generator=torch.Generator(device=device).manual_seed(int(seed)))

    os.makedirs(out_dir, exist_ok=True)
    for name, arr in (("positions", positions), ("n_methylated_reads_control", sim.obs_control.cpu().numpy()),
                      ("n_methylated_reads_case", sim.obs_case.cpu().numpy())):
        hio.write_count_matrix(os.path.join(out_dir, f"{name}_{chrom}.txt.gz"), arr)
    # The float32 depths as the JAX package writes them: "%s" of each value.
    for name, arr in (("n_total_reads_control", n_c), ("n_total_reads_case", n_k)):
        np.savetxt(os.path.join(out_dir, f"{name}_{chrom}.txt.gz"), arr, delimiter=",", fmt="%s")
    return RealisticFixture(
        positions=positions,
        states=sim.states.cpu().numpy(),
        island_mask=island,
        n_total_control=n_c,
        n_total_case=n_k,
    )
