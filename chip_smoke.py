#!/usr/bin/env python3
"""Smoke test of the PyTorch port (hygeia_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py               # the full check, as a user's run
    python3 chip_smoke.py --sites 5000  # a shorter segment, for a quick look

Phases, each of which raises (exit code non-zero) when it fails:

1. the card's name and power limit (nvidia-smi);
2. the build of hygeia_tpu_torch/csrc/*.cu for sm_90a, and its seconds;
3. the optimal-resampler kernel against its plain PyTorch version at
   U=32, N=2400, M=50 on the same uniforms: 8 trials of Gumbel weights with
   20% dead slots, a fallback case (fewer than M live weights) and an exact
   ties case; 8 trials more at the main path's own shape (U=1); then both
   timed with CUDA events over 100 calls, at U=32 and at U=1;
4. the slice: a seeded reference-format chromosome of 105,000 CpGs is
   written to a temporary directory and ``hygeia_tpu_torch.cli infer`` runs
   on it (segment 100,000 + halo 5,000, M=50 -> N=2400, B=25, f32), with
   checks on every output file, logZ, the degenerate-step count, the
   kernel's launch count and the planted differentially methylated windows.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Needs torch with CUDA and nvcc;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
R = 6
MU = (0.95, 0.05, 0.80, 0.20, 0.50, 0.50)
SIGMA = (0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


# ---------------------------------------------------------------- kernel ----

def _normalised_gumbel(rng, U, N, scale, dead_frac, device):
    import numpy as np
    import torch

    lw = rng.gumbel(size=(U, N)).astype(np.float32) * scale
    lw = np.where(rng.uniform(size=(U, N)) < dead_frac, -np.inf, lw).astype(np.float32)
    t = torch.from_numpy(lw).to(device)
    return (t - torch.logsumexp(t, dim=-1, keepdim=True)).contiguous()


def kernel_phase(device, U=32, N=2400, M=50, seed=0):
    """Kernel against plain version at U units and at the main path's U=1.
    Returns (max_abs_err, (kernel ms, plain ms) at U=1, the same at U)."""
    import numpy as np
    import torch
    from hygeia_tpu_torch.ops import resampling as plain
    from hygeia_tpu_torch.ops.cuda_resampling import optimal_resampling_cuda

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)

    def uniforms(units):
        return (torch.rand((units,), generator=gen, device=device),
                torch.rand((units, M), generator=gen, device=device))

    def compare(lw, label, exact=True):
        us, um = uniforms(lw.shape[0])
        got = optimal_resampling_cuda(lw, M, us, um)
        want = plain.optimal_finite_state_resampling(lw, M, us, um)
        torch.cuda.synchronize(device)
        if not exact:
            return got, 0.0
        check(torch.equal(got.use_unbiased, want.use_unbiased), f"{label}: fallback flags differ")
        check(torch.equal(got.top_m_indices, want.top_m_indices.to(torch.int32)), f"{label}: top-M indices differ")
        check(torch.equal(got.parent_indices, want.parent_indices), f"{label}: parents differ")
        err = 0.0
        for name in ("log_c", "new_log_weights"):
            g, w = getattr(got, name).double(), getattr(want, name).double()
            check(torch.allclose(g, w, rtol=1e-5, atol=1e-6), f"{label}: {name} differs beyond rtol 1e-5")
            err = max(err, float((g - w).abs().max()))
        return got, err

    max_err = 0.0
    for trial in range(8):
        lw = _normalised_gumbel(rng, U, N, 1.0 + trial, 0.2, device)
        max_err = max(max_err, compare(lw, f"trial {trial}")[1])
    print(f"kernel vs plain: 8 Gumbel trials U={U} N={N} M={M}: parents and top-M equal, "
          f"max |err| log_c/new_w {max_err:.3g}")

    few = np.full((U, N), -np.inf, np.float32)
    few[:, :10] = rng.gumbel(size=(U, 10))
    t = torch.from_numpy(few).to(device)
    lw = (t - torch.logsumexp(t, dim=-1, keepdim=True)).contiguous()
    got, err = compare(lw, "fallback")
    max_err = max(max_err, err)
    check(bool(got.use_unbiased.all()), "fallback: not every unit fell back")
    check(int(got.parent_indices.max()) < 10, "fallback: a dead slot was selected")
    print("kernel vs plain: fallback (10 live < M): equal, every unit multinomial")

    lw = torch.full((U, N), -math.log(N), dtype=torch.float32, device=device)
    got, _ = compare(lw, "ties", exact=False)
    check(not bool(got.use_unbiased.any()), "ties: unexpected fallback")
    c = torch.exp(got.log_c.double())[:, None]
    mass = torch.clamp(c * torch.exp(lw.double()), max=1.0).sum(dim=-1)
    check(bool(torch.allclose(mass, torch.full_like(mass, M), rtol=1e-3)), "ties: sum min(1, cW) != M")
    p = got.parent_indices
    check(int(p.min()) >= 0 and int(p.max()) < N, "ties: parent out of range")
    print("kernel ties: sum_i min(1, c W_i) = M holds for every unit")

    # The main path's own shape: one unit (one seed per CLI call).
    rng1 = np.random.default_rng(seed + 1)
    for trial in range(8):
        lw = _normalised_gumbel(rng1, 1, N, 1.0 + trial, 0.2, device)
        max_err = max(max_err, compare(lw, f"U=1 trial {trial}")[1])
    print(f"kernel vs plain: 8 Gumbel trials at the main path's shape U=1 N={N} M={M}: equal")

    def timed(units):
        """(kernel ms, plain ms) per call, CUDA events over 100 calls,
        in turns plain, kernel, kernel, plain; best of each pair."""
        lw = _normalised_gumbel(np.random.default_rng(seed + 2), units, N, 1.0, 0.2, device)
        us, um = uniforms(units)
        times = {}
        for name, fn in (("plain", plain.optimal_finite_state_resampling),
                         ("kernel", optimal_resampling_cuda),
                         ("kernel2", optimal_resampling_cuda),
                         ("plain2", plain.optimal_finite_state_resampling)):
            for _ in range(10):
                fn(lw, M, us, um)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(100):
                fn(lw, M, us, um)
            end.record()
            torch.cuda.synchronize(device)
            times[name] = start.elapsed_time(end) / 100
        k_ms = min(times["kernel"], times["kernel2"])
        p_ms = min(times["plain"], times["plain2"])
        print(f"resampler per call at U={units} N={N} M={M} (CUDA events, 100 calls, best of 2): "
              f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        return k_ms, p_ms

    k32, p32 = timed(U)
    k1, p1 = timed(1)
    return max_err, (k1, p1), (k32, p32)


# ----------------------------------------------------------------- slice ----

def make_dataset(root, n_sites, seed=0, n_dmr=20, dmr_len=300):
    """A reference-format chromosome "1": piecewise-constant control regimes
    drawn from the default mu/sigma Betas, Poisson(20) depth, 2 control and
    2 case samples; in n_dmr planted windows the case samples flip between
    the high (0.95) and low (0.05) regimes. Returns the DMR site mask."""
    import numpy as np
    from hygeia_tpu_torch.utils import io as hio

    rng = np.random.default_rng(seed)
    data_dir = os.path.join(root, "data")
    sg_dir = os.path.join(root, "single_group")
    lengths = rng.geometric(1 / 250, size=n_sites)
    regime_of_segment = rng.integers(0, R, size=lengths.size)
    regime = np.repeat(regime_of_segment, lengths)[:n_sites]
    case_regime = regime.copy()
    dmr = np.zeros(n_sites, bool)
    candidates = np.arange(1000, n_sites - dmr_len - 1000, dmr_len * 2)
    starts = rng.choice(candidates, min(n_dmr, max(1, candidates.size // 3)), replace=False)
    for s in starts:
        w = slice(s, s + dmr_len)
        case_regime[w] = np.where(np.asarray(MU)[regime[w]] >= 0.5, 1, 0)
        dmr[w] = True
    mu, sd = np.asarray(MU), np.asarray(SIGMA)
    nu = mu * (1 - mu) / sd**2 - 1
    a, b = mu * nu, (1 - mu) * nu

    def counts(reg):
        level = rng.beta(a[reg], b[reg])[:, None]
        n = rng.poisson(20, size=(n_sites, 2))
        return rng.binomial(n, np.broadcast_to(level, n.shape)), n

    y_c, n_c = counts(regime)
    y_k, n_k = counts(case_regime)
    positions = np.cumsum(rng.integers(1, 200, size=n_sites)) + 10_000
    hio.write_count_matrix(os.path.join(data_dir, "positions_1.txt.gz"), positions)
    hio.write_count_matrix(os.path.join(data_dir, "n_total_reads_control_1.txt.gz"), n_c)
    hio.write_count_matrix(os.path.join(data_dir, "n_methylated_reads_control_1.txt.gz"), y_c)
    hio.write_count_matrix(os.path.join(data_dir, "n_total_reads_case_1.txt.gz"), n_k)
    hio.write_count_matrix(os.path.join(data_dir, "n_methylated_reads_case_1.txt.gz"), y_k)
    theta = np.concatenate([np.zeros(R * (R - 1)), np.full(R, math.log(0.99 / 0.01))])
    hio.write_theta(os.path.join(sg_dir, "theta_1.csv.gz"), theta)
    return data_dir, sg_dir, dmr


def slice_phase(device, root, segment_size, buffer_size, seed=0):
    """Run the infer verb through the CLI on a seeded chromosome and check
    its outputs. Returns (stats dict, kernel launches in the run)."""
    import numpy as np
    import torch
    from hygeia_tpu_torch import cli
    from hygeia_tpu_torch.ops.cuda_resampling import KERNEL

    n_sites = segment_size + buffer_size
    t0 = time.perf_counter()
    data_dir, sg_dir, dmr = make_dataset(root, n_sites, seed)
    print(f"dataset: {n_sites} CpGs, {int(dmr.sum())} sites in planted DMRs, "
          f"written in {time.perf_counter() - t0:.1f} s")
    results = os.path.join(root, "results")
    argv = [
        "infer", "--data_dir", data_dir, "--single_group_dir", sg_dir,
        "--results_dir", results, "--chrom", "1",
        "--segment_size", str(segment_size), "--buffer_size", str(buffer_size),
        "--batch", "0", "--seed", str(seed), "--device", str(device),
    ]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    KERNEL.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    wall = time.perf_counter() - t0
    launches = KERNEL.launches
    print(out.getvalue().strip())

    T, N, B = n_sites, 50 * (2 * R + R * R), 25
    path = os.path.join(results, "chrom_1_0")
    expect = {
        f"optimal_backward_particles_merged_state_{N}_{seed}.npz": ((segment_size, B), np.int16),
        f"optimal_backward_particles_control_state_{N}_{seed}.npz": ((segment_size, B, 2), np.int32),
        f"optimal_backward_particles_case_state_{N}_{seed}.npz": ((segment_size, B, 2), np.int32),
        f"optimal_split_probs_{N}_{seed}.npz": ((T,), np.float32),
        f"optimal_regime_probs_{N}_{seed}.npz": ((T, 2 * R), np.float32),
    }
    arrays = {}
    for name, (shape, dtype) in expect.items():
        arr = np.load(os.path.join(path, name))["arr_0"]
        check(arr.shape == shape and arr.dtype == dtype, f"{name}: {arr.shape} {arr.dtype}, expected {shape} {dtype}")
        arrays[name] = arr
    for name in ("observations_control", "observations_case", "n_total_reads_control",
                 "n_total_reads_case", "positions"):
        check(os.path.exists(os.path.join(path, f"{name}.csv.gz")), f"missing {name}.csv.gz")
    texts = {}
    for name in (f"flags{seed}.txt", f"log_normalizing_constants_optimal_{seed}.txt",
                 f"optimal_time_{seed}.txt", f"optimal_time_backward_{seed}.txt"):
        with open(os.path.join(path, name)) as f:
            texts[name] = f.read()
    log_z = ast.literal_eval(texts[f"log_normalizing_constants_optimal_{seed}.txt"])[N]
    t_f = ast.literal_eval(texts[f"optimal_time_{seed}.txt"])[N]
    t_b = ast.literal_eval(texts[f"optimal_time_backward_{seed}.txt"])[N]
    check(math.isfinite(log_z), f"logZ not finite: {log_z}")
    check(f"seed {seed}: degenerate_steps=0" in out.getvalue(), "degenerate filter steps")
    check(launches >= T - 1, f"kernel launched {launches} times for T={T} sites")
    split = arrays[f"optimal_split_probs_{N}_{seed}.npz"]
    regime = arrays[f"optimal_regime_probs_{N}_{seed}.npz"]
    check(bool(np.all(np.isfinite(split))) and bool(np.all(np.isfinite(regime))), "non-finite probabilities")
    check(np.allclose(regime[:, :R].sum(1), 1, atol=1e-5), "control regime probabilities do not sum to 1")
    in_dmr, out_dmr = float(split[dmr].mean()), float(split[~dmr].mean())
    check(in_dmr > out_dmr, f"split probability inside DMRs {in_dmr:.3f} <= outside {out_dmr:.3f}")
    stats = {
        "sites": T, "logZ": log_z, "filter_s": t_f, "backward_s": t_b, "wall_s": wall,
        "sites_per_s": T / (t_f + t_b), "split_in_dmr": in_dmr, "split_outside": out_dmr,
        "max_memory_allocated_bytes": (torch.cuda.max_memory_allocated(device)
                                       if device.type == "cuda" else None),
    }
    print(f"slice: T={T} N={N} B={B} logZ={log_z:.3f} launches={launches} "
          f"filter {t_f:.2f} s, backward {t_b:.2f} s, {stats['sites_per_s']:.1f} sites/s, "
          f"split prob in DMRs {in_dmr:.3f} vs outside {out_dmr:.3f}, "
          f"max_memory_allocated {stats['max_memory_allocated_bytes']}")
    return stats, launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sites", type=int, default=100_000, help="segment size (default 100000)")
    ap.add_argument("--buffer", type=int, default=5_000, help="halo size (default 5000)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to check", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "hygeia_tpu_torch")):
        print(f"chip_smoke: no hygeia_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    device = torch.device("cuda", 0)

    card = card_line()
    print(card)

    from hygeia_tpu_torch.ops import build
    from hygeia_tpu_torch.ops.cuda_resampling import KERNEL

    t0 = time.perf_counter()
    KERNEL.load()
    info = KERNEL.build
    print(f"build: {info.path.name} from {[s.name for s in build.sources()]} "
          f"in {time.perf_counter() - t0:.2f} s (nvcc {info.seconds:.2f} s)")
    for line in info.log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    max_err, (k_ms, p_ms), (k32_ms, p32_ms) = kernel_phase(device)

    root = tempfile.mkdtemp(prefix="hygeia_smoke_")
    try:
        stats, launches = slice_phase(device, root, args.sites, args.buffer)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    print(json.dumps({"kernels": [{
        "name": "optimal_resampling",
        "route": "cuda",
        "source": "hygeia_tpu_torch/csrc/optimal_resampling.cu",
        "replaces": "hygeia_tpu/ops/pallas_resampling.py:50",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "shape": "U=1 N=2400 M=50 (one seed per infer call)",
        "ms_u32": k32_ms,
        "plain_ms_u32": p32_ms,
    }], "card": card, "slice": stats}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
