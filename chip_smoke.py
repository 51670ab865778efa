#!/usr/bin/env python3
"""Smoke test of the PyTorch port (hygeia_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py                                       # the full check
    python3 chip_smoke.py --chrom_sites 105000                  # phase 5's chromosome as long as it was
    python3 chip_smoke.py --chrom_sites 3300 --sites 3000 --buffer 300 --stream_block 512 \
        --chrom2_sites 3000 --robust_sites 600 --robust_buffer 60 --theta_block 1024 \
        --theta_halo 128 --theta_warmup 1024 --pipeline_sites 2600 --sg_pipeline_sites 1500 \
        --marginal_sites 1500 --marginal_buffer 150   # a quick look

Phases, each of which raises (exit code non-zero) when it fails:

1. the card's name and power limit (nvidia-smi);
2. the build of hygeia_tpu_torch/csrc/*.cu for sm_90a, and its seconds;
3. the optimal-resampler kernel against its plain PyTorch version on the
   same uniforms (parents, top-M indices and fallback flags equal; log_c
   and the new weights within rtol 1e-5):
   - two-group INFER's shape U=32, N=2400, M=50: 8 trials of Gumbel
     weights with 20% dead slots, a fallback case (fewer than M live
     weights) and an exact ties case; 8 trials more at U=1;
   - the single-group engine's shape N=250, M=244 at U=1 and U=8:
     growth-phase weights (the first 6(t+1) slots live, t = 1, 20, 40), 8
     trials of Gumbel weights, an exact ties case;
   - two-group M=150 (N=7200), past the old 128-slot bound;
   then timed at U=1 for both main shapes, at U=32 for the two-group one,
   at U=48 for the single-group one (the blocked theta stage's units) and
   at N=7200, M=150: per call through the wrapper (CUDA events over 100
   calls, beside the plain version), the card's time per launch (launches
   into preallocated outputs through the C entry, queued behind a spin on
   the card), the wrapper's host time per enqueue (1,000 calls, no
   synchronisation), an empty launch through the same interface, the
   bandwidth bound of the shape, and torch.topk(lw, M + 1) as the
   yardstick of the first stage alone;
4. the single-group hazard tables (``build_tables`` at the CLI defaults,
   kappa fixed and free) on the card and on the CPU: bit-identical f32
   rho, exit latch and gradient tables, and latch onsets equal to the JAX
   package's f32 tables' on the CPU (pinned here, JAX_ONSETS; the card's
   machine has no JAX, tests/test_torch_single_group.py holds the pin);
   then the f32 BetaBinomial emission table (infer and single-group
   defaults, 2 and 8 samples) and the two-group hazard table rho (six
   omega, kappa 2, u 3, d_max 4096), bit-identical on the card and the CPU
   (tests/test_torch_ops.py holds the CPU tables to JAX's bit for bit);
5. a seeded reference-format chromosome of 40,000 CpGs is written to a
   temporary directory: 2 control + 2 case samples for ``infer`` and the
   two control samples as headed CSVs for the single-group engine, which
   reads all of it (cut from 105,000, so that phases 10-12 fit);
6. ``hygeia_tpu_torch.cli estimate_parameters_and_regimes`` on the control
   samples (N=250, M_cap=244, S_cap=128, D=36, both estimates on, f32),
   with checks on its output files, logZ, the theta trace, the kernel's
   launch count and the planted high and low methylation stretches; its
   theta file is the one the next phase reads;
7. ``hygeia_tpu_torch.cli infer`` on the estimated theta, batch 0 of the
   chromosome (segment 10,000 + halo 1,000, M=50 -> N=2400, B=25, f32;
   the segment is cut from the production 100,000, from the 50,000 it had
   while a host ran both site loops at 2.8-3.6 ms a site, and from the
   30,000 + 5,000 it had before phases 8 and 9 came), with checks on every
   output file, logZ, the degenerate-step count, the kernel's launch count
   and the planted differentially methylated windows;
8. ``infer --streaming_blocks 2048`` (runner.infer_segment, as the CLI
   calls it, with its per-block timings; ``--stream_block``) on the same
   window and seed: 6 blocks (5 x 2,048 + 760). Every npz array equal to phase 7's bit for
   bit, logZ within rtol 1e-5 of phase 7's, every block's re-run equal to
   its checkpoint, the kernel launched 2T - len_last - 2 times, peak
   max_memory_allocated below half of phase 7's; the device-to-host copy
   of each block's trajectories is timed;
9. ``runner.infer_chromosome_streamed`` on a second seeded chromosome "2"
   of 11,000 CpGs with planted DMRs and phase 6's theta: segment 2,000,
   halo 200, seeds (0, 1), W=1,024, so windows of 2,200, 2,400 and 1,200
   sites in groups of 2, 8 and 2 units. Every (batch, seed) file's name,
   shape and dtype, logZ finite, no degenerate step, the split probability
   higher inside the DMRs than outside, and launches equal to the sum of
   the per-chunk formula; sites x units per second is printed;
10. ``infer --robust`` through the CLI on batch 0 of phase 5's chromosome
   (segment 3,000 + halo 300, one seed, phase 6's theta): the f32 robust
   emission table built on the card equal to the CPU's bit for bit, and
   within rtol 1e-5 of the float64 table, logZ finite and not that of a BetaBinomial run of
   the same window, no degenerate step, T - 1 launches, the split
   probability higher inside the DMRs than outside;
11. ``single_group.blocked.run_online_combined_inference_blocked`` on phase
   5's 40,000 control CpGs at the CLI's defaults (N=250, M_cap=244, both
   estimates on, f32), block 8,192 + halo 1,024 and a warmup of 8,192
   sites (cut from the production 49,152 / 4,096 / 65,536 for time): 5
   blocks, (Tw - 1) + (win - 1) launches (one launch serves every block),
   the warmup's theta trace equal to phase 6's first Tw rows bit for bit
   (the same generator), regime modes agreeing with phase 6's on more than
   95% of the sites where either run is confident (max probability > 0.9;
   the bound of tests/test_blocked_engine.py), the final theta nearer phase
   6's than the starting theta is (max |difference| of omega and of P:
   both chains moved the same way), the planted stretches recovered; then
   the engine's ms per site over 300 sites at U = 1, 8 and 48;
12. ``hygeia_tpu_torch.cli run --two_group`` from BED files written here (a
   CpG list and 2 control + 2 case samples of a third chromosome "3" of
   13,000 CpGs, with 10 case-only DMR windows of 300 sites), batches of
   6,000 + halo 600 (3 batches), 2 seeds, the default FDR thresholds,
   sequential theta: the stage tree 1_PREPROCESS/ .. 6_GET_DMPS/ with the
   JAX orchestrator's file names, aggregate tables of 13,000 rows x 50
   trajectories, (T - 1) + sum over batches of (window - 1) launches (one
   launch a site serves both seeds), weighted_dmp_0.05.csv non-empty with
   at least half its positions in planted windows (recall printed); a
   second invocation runs no stage again;
13. ``hygeia_tpu_torch.cli run`` (the single-group pipeline) from a sample
   sheet of 2 BED samples of a fourth chromosome "4" of 5,000 CpGs with
   planted high and low stretches, at the run verb's defaults (R=6,
   N=250 so M=244, u=3, d_max 4096, f32): both batched passes with U=2,
   2 (T - 1) launches, a tabix query over each .bed.gz equal to a plain
   scan, make_bed_file on the stage's regime file equal to the stage's
   bytes, a re-run that runs no stage; then ``preprocess --format gembs``
   on the same samples' counts written as gemBS tab files, the counts read
   back equal; then ``run_single_group(samples=...)`` on the preprocessed
   directories with tests/test_orchestrator.py's learning settings (an
   update every 50 sites at rate 0.2): 2 (T - 1) launches and the regime
   modes on more than 0.6 of the planted high and low stretches (that
   test's bound). At the CLI defaults the recovery is printed, not held:
   from the port's start draw both packages settle in regime 0, whose
   float32 hazard is exactly 0 past a sojourn of 59 with no exit latch,
   and stay there (tests/test_torch_single_group_pipeline.py::
   test_both_passes_from_the_ports_start_agree_with_jax);
14. ``infer --marginal`` (runner.infer_segment) on batch 0 of phase 5's
   chromosome, segment 2,000 + halo 200 (cut for time), phase 6's theta,
   M=50 (N=2400), window 64, seeds 0 and 1 in one call: T - 1 launches,
   logZ finite, the spill counts printed, the split probability higher
   inside the planted DMRs than outside, the split and the regime
   probabilities within 0.1 and 0.07 (mean absolute) of phase 7's
   backward-simulation ones on the same sites, peak memory beside phase
   7's.

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
SG_MU = (0.99, 0.01, 0.80, 0.20, 0.50, 0.50)  # the single-group CLI's defaults
SG_SIGMA = (0.05, 0.05, 0.20, 0.20, 0.20, 0.2886751)
SG_N = 250  # the single-group CLI's --n_particles default: M_cap = N - R
# The JAX package's f32 exit-latch onsets at the CLI defaults (d_max 4096;
# None: no latch), as its CPU computes the tables; the port's f32 tables
# are JAX's bit for bit (tests/test_torch_single_group.py).
JAX_ONSETS = {"kappa fixed": [3728, None, None, None, None, None],
              "kappa free": [3728, None, None, None, None, None]}
CHROM2 = dict(segment_size=2000, buffer_size=200, seeds=(0, 1), block=1024)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


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


def kernel_phase(device, seed=0):
    """Kernel against plain version at the two main paths' shapes and past
    the old bounds. Returns (max_abs_err, {label: the shape's times})."""
    import numpy as np
    import torch
    from hygeia_tpu_torch.ops import resampling as plain
    from hygeia_tpu_torch.ops.cuda_resampling import KERNEL, optimal_resampling_cuda

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)

    def uniforms(units, M):
        return (torch.rand((units,), generator=gen, device=device),
                torch.rand((units, M), generator=gen, device=device))

    def compare(lw, M, label, exact=True):
        us, um = uniforms(lw.shape[0], M)
        got = optimal_resampling_cuda(lw, M, us, um)
        want = plain.optimal_finite_state_resampling(lw, M, us, um)
        torch.cuda.synchronize(device)
        check(torch.equal(got.top_m_indices, want.top_m_indices.to(torch.int32)), f"{label}: top-M indices differ")
        if not exact:
            return got, 0.0
        check(torch.equal(got.use_unbiased, want.use_unbiased), f"{label}: fallback flags differ")
        check(torch.equal(got.parent_indices, want.parent_indices), f"{label}: parents differ")
        err = 0.0
        for name in ("log_c", "new_log_weights"):
            g, w = getattr(got, name).double(), getattr(want, name).double()
            check(torch.allclose(g, w, rtol=1e-5, atol=1e-6), f"{label}: {name} differs beyond rtol 1e-5")
            err = max(err, float((g - w).abs().max()))
        return got, err

    def ties_invariant(got, lw, M, label):
        check(not bool(got.use_unbiased.any()), f"{label}: unexpected fallback")
        c = torch.exp(got.log_c.double())[:, None]
        mass = torch.clamp(c * torch.exp(lw.double()), max=1.0).sum(dim=-1)
        check(bool(torch.allclose(mass, torch.full_like(mass, M), rtol=1e-3)), f"{label}: sum min(1, cW) != M")
        p = got.parent_indices
        check(int(p.min()) >= 0 and int(p.max()) < lw.shape[1], f"{label}: parent out of range")

    max_err = 0.0
    # Two-group INFER: N = 2400, M = 50.
    U, N, M = 32, 2400, 50
    for trial in range(8):
        lw = _normalised_gumbel(rng, U, N, 1.0 + trial, 0.2, device)
        max_err = max(max_err, compare(lw, M, f"trial {trial}")[1])
    print(f"kernel vs plain: 8 Gumbel trials U={U} N={N} M={M}: parents and top-M equal, "
          f"max |err| log_c/new_w {max_err:.3g}")

    few = np.full((U, N), -np.inf, np.float32)
    few[:, :10] = rng.gumbel(size=(U, 10))
    t = torch.from_numpy(few).to(device)
    lw = (t - torch.logsumexp(t, dim=-1, keepdim=True)).contiguous()
    got, err = compare(lw, M, "fallback")
    max_err = max(max_err, err)
    check(bool(got.use_unbiased.all()), "fallback: not every unit fell back")
    check(int(got.parent_indices.max()) < 10, "fallback: a dead slot was selected")
    print("kernel vs plain: fallback (10 live < M): equal, every unit multinomial")

    lw = torch.full((U, N), -math.log(N), dtype=torch.float32, device=device)
    got, _ = compare(lw, M, "ties", exact=False)
    ties_invariant(got, lw, M, "ties")
    print("kernel ties: top-M equal, sum_i min(1, c W_i) = M holds for every unit")

    rng1 = np.random.default_rng(seed + 1)
    for trial in range(8):
        lw = _normalised_gumbel(rng1, 1, N, 1.0 + trial, 0.2, device)
        max_err = max(max_err, compare(lw, M, f"U=1 trial {trial}")[1])
    print(f"kernel vs plain: 8 Gumbel trials at U=1 N={N} M={M}: equal")

    # The single-group engine: N = 250, M_cap = 244 (the sort path).
    N_sg, M_sg = SG_N, SG_N - R
    for units in (1, 8):
        for t_site in (1, 20, 40):
            live = min(R * (t_site + 1), N_sg)
            g = rng.gumbel(size=(units, N_sg)).astype(np.float32)
            g[:, live:] = -np.inf
            t = torch.from_numpy(g).to(device)
            lw = (t - torch.logsumexp(t, dim=-1, keepdim=True)).contiguous()
            max_err = max(max_err, compare(lw, M_sg, f"growth t={t_site} U={units}")[1])
        for trial in range(8):
            lw = _normalised_gumbel(rng, units, N_sg, 1.0 + trial, 0.0, device)
            max_err = max(max_err, compare(lw, M_sg, f"sg trial {trial} U={units}")[1])
        lw = torch.full((units, N_sg), -math.log(N_sg), dtype=torch.float32, device=device)
        got, _ = compare(lw, M_sg, f"sg ties U={units}", exact=False)
        ties_invariant(got, lw, M_sg, f"sg ties U={units}")
    print(f"kernel vs plain at the engine's N={N_sg} M={M_sg}, U=1 and 8: growth phase "
          f"(t = 1, 20, 40), 8 Gumbel trials: equal; ties: top-M equal, invariant holds")

    # Two-group M = 150: N = 7200, past the old bounds (M + 1 <= 128, N <= 5233).
    N_big, M_big = 150 * (2 * R + R * R), 150
    for trial in range(4):
        lw = _normalised_gumbel(rng, 4, N_big, 1.0 + trial, 0.2, device)
        max_err = max(max_err, compare(lw, M_big, f"M=150 trial {trial}")[1])
    print(f"kernel vs plain: 4 Gumbel trials U=4 N={N_big} M={M_big}: equal")

    def events_ms(fn, n, behind_spin):
        """Milliseconds per call of fn by CUDA events over n calls. Behind a
        spin on the card the calls queue up first, so the events time the
        card and not the host that enqueues."""
        for _ in range(10):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if behind_spin:
            torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / n

    def host_us(fn, n=1000):
        """Host microseconds per call of fn, no synchronisation in between."""
        for _ in range(20):
            fn()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize(device)
        return 1e6 * dt / n

    def timed(units, N, M):
        """The shape's times. ms, plain_ms: per call through the wrapper and
        of the plain version, CUDA events over 100 calls, in turns plain,
        kernel, kernel, plain, best of each pair. device_ms: per launch into
        preallocated outputs through the C entry, behind a spin, best of 3.
        enqueue_us: the wrapper's host time per call, best of 3. library_ms:
        torch.topk(lw, M + 1), the first stage's yardstick. bound_ms: the
        shape's bytes (every input read once, every output written once)
        over 3.35 TB/s. The operations never set the bound: even at 24 a
        weight they take 24 N / 67 TFLOP/s, less than the 4 N bytes of the
        weights alone take at 3.35 TB/s."""
        lw = _normalised_gumbel(np.random.default_rng(seed + 2), units, N, 1.0, 0.2 if N > SG_N else 0.0, device)
        us, um = uniforms(units, M)
        outs = (torch.empty((units, M), dtype=torch.int32, device=device),
                torch.empty((units, M), dtype=torch.float32, device=device),
                torch.empty((units, M), dtype=torch.int32, device=device),
                torch.empty((units,), dtype=torch.float32, device=device),
                torch.empty((units,), dtype=torch.bool, device=device))
        raw_args = (lw.data_ptr(), us.data_ptr(), um.data_ptr(), units, N, M,
                    *[o.data_ptr() for o in outs], torch.cuda.current_stream(device).cuda_stream)

        def raw():
            check(KERNEL.launch(*raw_args) == 0, "raw launch refused")

        device_ms = min(events_ms(raw, 100, True) for _ in range(3))
        enqueue_us = min(host_us(lambda: optimal_resampling_cuda(lw, M, us, um)) for _ in range(3))
        library_ms = min(events_ms(lambda: torch.topk(lw, M + 1), 100, True) for _ in range(3))
        n_bytes = units * (4 * N + 4 + 4 * M + 12 * M + 5)
        times = {}
        for name, fn in (("plain", plain.optimal_finite_state_resampling),
                         ("kernel", optimal_resampling_cuda),
                         ("kernel2", optimal_resampling_cuda),
                         ("plain2", plain.optimal_finite_state_resampling)):
            times[name] = events_ms(lambda: fn(lw, M, us, um), 100, False)
        out = {
            "ms": min(times["kernel"], times["kernel2"]),
            "plain_ms": min(times["plain"], times["plain2"]),
            "device_ms": device_ms, "enqueue_us": enqueue_us, "library_ms": library_ms,
            "bytes": n_bytes, "bound_ms": 1e3 * n_bytes / 3.35e12, "bound_by": "bytes",
        }
        print(f"resampler at U={units} N={N} M={M}: per call through the wrapper {out['ms']:.4f} ms "
              f"(plain {out['plain_ms']:.4f} ms; CUDA events, 100 calls, best of 2); on the card "
              f"{1e3 * device_ms:.2f} us a launch; enqueue {enqueue_us:.2f} us of host time; "
              f"bound {1e6 * out['bound_ms']:.1f} ns ({n_bytes} bytes, by {out['bound_by']}); "
              f"torch.topk(lw, M + 1) alone {1e3 * library_ms:.2f} us")
        return out

    empty_args = (torch.cuda.current_stream(device).cuda_stream,)

    def empty():
        check(KERNEL.lib.hygeia_empty_launch(*empty_args) == 0, "empty launch refused")

    floor = {"launch_floor_ms": min(events_ms(empty, 1000, True) for _ in range(3)),
             "launch_floor_host_us": min(host_us(empty) for _ in range(3))}
    print(f"an empty one-block launch through the same C interface: {1e3 * floor['launch_floor_ms']:.2f} us "
          f"on the card, {floor['launch_floor_host_us']:.2f} us of host time")
    times = {
        "floor": floor,
        "single_group": timed(1, N_sg, M_sg),
        "two_group": timed(1, N, M),
        "two_group_u32": timed(U, N, M),
        "two_group_m150": timed(1, N_big, M_big),
        "single_group_u48": timed(48, N_sg, M_sg),
    }
    return max_err, times


# ---------------------------------------------------------------- hazard ----

def hazard_phase(device):
    """build_tables at the CLI defaults on the card and on the CPU: the f32
    tables must be bit-identical. Returns the latch onsets per regime."""
    import numpy as np
    import torch
    from hygeia_tpu_torch.single_group.model import build_tables, make_model, parameters_to_theta

    p = np.full((R, R), 1.0 / (R - 1))
    np.fill_diagonal(p, 0.0)
    omega = np.array([0.995, 0.975, 0.950, 0.925, 0.900, 0.900])
    kappa = np.full(R, 2.0)
    sigma = SG_SIGMA
    onsets = {}
    for kappa_fixed in (True, False):
        theta = parameters_to_theta(p, omega, kappa, kappa_fixed=kappa_fixed)
        tables = {}
        for dev in (torch.device("cpu"), device):
            model = make_model(SG_MU, sigma, 2, kappa, kappa_fixed=kappa_fixed, d_max=4096, device=dev)
            th = torch.as_tensor(theta, dtype=torch.float32, device=dev)
            tables[dev.type] = build_tables(model, th)
        label = "kappa fixed" if kappa_fixed else "kappa free"
        names = ["rho", "exit_status", "grad_omega_log_rho"] + ([] if kappa_fixed else ["grad_kappa_log_rho"])
        for name in names:
            a, b = getattr(tables["cpu"], name), getattr(tables["cuda"], name).cpu()
            check(a.dtype == b.dtype and torch.equal(a, b),
                  f"hazard {label}: {name} differs between the CPU and the card "
                  f"({int((a != b).sum())} entries)")
        ex = tables["cuda"].exit_status.cpu().numpy()
        onsets[label] = [int(r.argmax()) if r.any() else None for r in ex]
        check(onsets[label] == JAX_ONSETS[label],
              f"hazard {label}: latch onsets {onsets[label]}, the JAX package's {JAX_ONSETS[label]}")
        print(f"hazard tables ({label}, f32, d_max 4096): CPU and card bit-identical "
              f"({', '.join(names)}); exit-latch onsets per regime {onsets[label]}, the JAX package's")
    two_group_tables_phase(device)
    return onsets


# The six omega of the two-group rho check: the case default, sigmoid(+-2),
# and the single-group CLI's control defaults.
RHO_OMEGA = (0.8, 1 / (1 + math.exp(-2.0)), 1 / (1 + math.exp(2.0)), 0.995, 0.975, 0.9)


def two_group_tables_phase(device):
    """The float32 BetaBinomial emission table (infer and single-group
    defaults, 2 and 8 samples) and the two-group hazard table rho (the six
    RHO_OMEGA, kappa 2, u 3, d_max 4096) built on the card and on the CPU:
    bit-identical (both are the JAX package's eager f32 tables on the CPU,
    tests/test_torch_ops.py)."""
    import numpy as np
    import torch
    from hygeia_tpu_torch.ops.distributions import mu_sigma_to_alpha_beta
    from hygeia_tpu_torch.ops.emissions import emission_log_prob_table
    from hygeia_tpu_torch.ops.hazard import rho_two_group

    rng = np.random.default_rng(4)
    for S in (2, 8):
        n = rng.poisson(20, size=(5000, S)).astype(np.float32)
        n[::13] = 0
        y = np.minimum(rng.poisson(10, size=n.shape), n).astype(np.float32)
        for label, (mu, sigma) in (("infer", (MU, SIGMA)), ("single-group", (SG_MU, SG_SIGMA))):
            tabs = []
            for dev in (torch.device("cpu"), device):
                a, b = mu_sigma_to_alpha_beta(torch.tensor(mu, dtype=torch.float32, device=dev),
                                              torch.tensor(sigma, dtype=torch.float32, device=dev))
                tabs.append(emission_log_prob_table(y, n, a, b).cpu())
            check(torch.equal(tabs[0], tabs[1]),
                  f"emission table ({label} defaults, S={S}): {int((tabs[0] != tabs[1]).sum())} entries differ "
                  f"between the CPU and the card")
    omega = torch.tensor(RHO_OMEGA, dtype=torch.float32)
    kappa = torch.full((len(RHO_OMEGA),), 2.0)
    rho = [rho_two_group(kappa.to(dev), omega.to(dev), 3, 4096).cpu() for dev in (torch.device("cpu"), device)]
    check(torch.equal(rho[0], rho[1]), f"rho: {int((rho[0] != rho[1]).sum())} entries differ between the CPU "
                                       "and the card")
    onset = [int(r.int().argmax()) if r.any() else None for r in (rho[1] == np.float32(0.1))]
    print(f"two-group tables (f32): the BetaBinomial emission table (infer and single-group defaults, S = 2 "
          f"and 8, 5,000 sites) and rho (omega {[round(o, 4) for o in RHO_OMEGA]}, kappa 2, u 3, d_max 4096) "
          f"bit-identical on the CPU and the card; rho's 0.1-guard onsets {onset}")


# ----------------------------------------------------------------- slice ----

def make_dataset(root, n_sites, seed=0, n_dmr=20, dmr_len=300, chrom="1"):
    """A reference-format chromosome: piecewise-constant control regimes
    drawn from the default mu/sigma Betas, Poisson(20) depth, 2 control and
    2 case samples; in n_dmr planted windows the case samples flip between
    the high (0.95) and low (0.05) regimes. The control samples are also
    written as the single-group engine's headed CSVs. Returns (data dir,
    single-group dir, DMR site mask, control regime of every site)."""
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
    hio.write_count_matrix(os.path.join(data_dir, f"positions_{chrom}.txt.gz"), positions)
    hio.write_count_matrix(os.path.join(data_dir, f"n_total_reads_control_{chrom}.txt.gz"), n_c)
    hio.write_count_matrix(os.path.join(data_dir, f"n_methylated_reads_control_{chrom}.txt.gz"), y_c)
    hio.write_count_matrix(os.path.join(data_dir, f"n_total_reads_case_{chrom}.txt.gz"), n_k)
    hio.write_count_matrix(os.path.join(data_dir, f"n_methylated_reads_case_{chrom}.txt.gz"), y_k)
    if chrom != "1":
        return data_dir, sg_dir, dmr, regime
    sg_in = os.path.join(root, "single_group_input")
    hio.write_headed_matrix(os.path.join(sg_in, "n_methylated_reads_1.csv"), y_c.T, "sample")
    hio.write_headed_matrix(os.path.join(sg_in, "n_total_reads_1.csv"), n_c.T, "sample")
    hio.write_headed_column(os.path.join(sg_in, "genomic_positions_1.csv"), positions, "genomic_positions")
    return data_dir, sg_dir, dmr, regime


def make_bed_dataset(root, n_sites, seed=3, chrom="3", n_dmr=10, dmr_len=300, with_regime=False):
    """The pipeline phase's input: a tab-separated CpG list (seqID, start)
    and 2 control + 2 case BED methylation files of a seeded chromosome,
    regimes and counts drawn as ``make_dataset`` draws them, with case-only
    DMR windows. A third of the sites carry both strands (the counts split
    between a + and a - record), the rest a + record; sites without reads
    have no record. Returns (CpG file, control BEDs, case BEDs, DMR mask,
    0-based positions), and the control regime of every site after them
    with ``with_regime``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = rng.geometric(1 / 250, size=n_sites)
    regime = np.repeat(rng.integers(0, R, size=lengths.size), lengths)[:n_sites]
    case_regime = regime.copy()
    dmr = np.zeros(n_sites, bool)
    candidates = np.arange(500, n_sites - dmr_len - 500, dmr_len * 2)
    for s in rng.choice(candidates, min(n_dmr, candidates.size), replace=False):
        w = slice(s, s + dmr_len)
        case_regime[w] = np.where(np.asarray(MU)[regime[w]] >= 0.5, 1, 0)
        dmr[w] = True
    mu, sd = np.asarray(MU), np.asarray(SIGMA)
    nu = mu * (1 - mu) / sd**2 - 1
    a, b = mu * nu, (1 - mu) * nu
    pos0 = np.cumsum(rng.integers(2, 200, size=n_sites)) + 10_000
    os.makedirs(root, exist_ok=True)
    cpg = os.path.join(root, f"cpg_{chrom}.tsv")
    with open(cpg, "w") as f:
        f.write("seqID\tstart\n" + "".join(f"{chrom}\t{p + 1}\n" for p in pos0))

    def bed(path, reg):
        level = rng.beta(a[reg], b[reg])
        n = rng.poisson(20, size=n_sites)
        y = rng.binomial(n, level)
        split = rng.random(n_sites) < 1 / 3
        n_minus = np.where(split, n // 2, 0)
        y_minus = np.minimum(y, n_minus)
        lines = ["track name=smoke"]
        for i in np.flatnonzero(n > 0):
            p = int(pos0[i])
            for strand, start, cov, meth in (("+", p, n[i] - n_minus[i], y[i] - y_minus[i]),
                                             ("-", p + 1, n_minus[i], y_minus[i])):
                if cov > 0:
                    pct = repr(float(100.0 * meth / cov))
                    lines.append(f"{chrom}\t{start}\t{start + 1}\t.\t0\t{strand}\t{start}\t{start + 1}"
                                 f"\t0,0,0\t{cov}\t{pct}\tCG\tCG\t30")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return path

    controls = [bed(os.path.join(root, f"control_{i}.bed"), regime) for i in range(2)]
    cases = [bed(os.path.join(root, f"case_{i}.bed"), case_regime) for i in range(2)]
    if with_regime:
        return cpg, controls, cases, dmr, pos0, regime
    return cpg, controls, cases, dmr, pos0


def single_group_phase(device, root, regime):
    """Run estimate_parameters_and_regimes through the CLI on the control
    samples and check its outputs; its theta file is what infer reads next.
    Returns (stats dict, kernel launches in the run)."""
    import numpy as np
    import torch
    from hygeia_tpu_torch import cli
    from hygeia_tpu_torch.ops.cuda_resampling import KERNEL
    from hygeia_tpu_torch.utils import io as hio

    sg_in = os.path.join(root, "single_group_input")
    sg_dir = os.path.join(root, "single_group")
    T = regime.size
    argv = [
        "estimate_parameters_and_regimes",
        "--n_methylated_reads_csv_file", os.path.join(sg_in, "n_methylated_reads_1.csv"),
        "--n_total_reads_csv_file", os.path.join(sg_in, "n_total_reads_1.csv"),
        "--genomic_positions_csv_file", os.path.join(sg_in, "genomic_positions_1.csv"),
        "--estimate_parameters", "--estimate_regime_probabilities",
        "--n_particles", str(SG_N), "--device", str(device),
        "--regime_probabilities_csv_file", os.path.join(sg_dir, "regime_probs_1.csv"),
        "--theta_trace_csv_file", os.path.join(sg_dir, "theta_trace_1.csv"),
        "--p_csv_file", os.path.join(sg_dir, "p_1.csv"),
        "--omega_csv_file", os.path.join(sg_dir, "omega_1.csv"),
        "--kappa_csv_file", os.path.join(sg_dir, "kappa_1.csv"),
        "--theta_file", os.path.join(sg_dir, "theta_1.csv.gz"),
        "--progress_every", "0",
    ]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    KERNEL.launches = 0
    t0 = time.perf_counter()
    res = cli.main(argv)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = KERNEL.launches

    names = {
        "regime_probs_1.csv": ["genomic_position"] + [f"regime_{i + 1}" for i in range(R)],
        "theta_trace_1.csv": [f"theta_{i + 1}" for i in range(R * R)],
        "p_1.csv": [f"regime_{i + 1}" for i in range(R)],
        "omega_1.csv": ["omega"],
        "kappa_1.csv": ["kappa"],
        "theta_1.csv.gz": ["data"],
    }
    shapes = {"regime_probs_1.csv": (T, 1 + R), "theta_trace_1.csv": (T, R * R), "p_1.csv": (R, R),
              "omega_1.csv": (R, 1), "kappa_1.csv": (R, 1), "theta_1.csv.gz": (R * R, 1)}
    tabs = {}
    for name, header in names.items():
        path = os.path.join(sg_dir, name)
        check(os.path.exists(path), f"single group: missing {name}")
        cols, vals = hio.read_headed_table(path)
        check(cols == header, f"single group: {name} header {cols[:3]}..., expected {header[:3]}...")
        check(vals.shape == shapes[name], f"single group: {name} shape {vals.shape}, expected {shapes[name]}")
        tabs[name] = vals
    log_z = float(res.log_normalizing_constant[0])
    spill = int(res.spill_count[0])
    check(math.isfinite(log_z), f"single group: logZ not finite: {log_z}")
    check(bool(np.isfinite(tabs["theta_trace_1.csv"]).all()), "single group: non-finite theta trace")
    check(np.allclose(tabs["p_1.csv"].sum(1), 1, atol=1e-5), "single group: rows of P do not sum to 1")
    probs = tabs["regime_probs_1.csv"][:, 1:]
    check(bool(np.isfinite(probs).all()), "single group: non-finite regime probabilities")
    check(np.allclose(probs.sum(1), 1, atol=1e-4), "single group: regime probabilities do not sum to 1")
    # One launch a site resamples every unit; the first site resamples nothing.
    check(launches == T - 1, f"single group: kernel launched {launches} times for T={T} sites")
    level = probs @ np.asarray(SG_MU)
    mu_true = np.asarray(MU)[regime]
    hi, lo = float(level[mu_true >= 0.8].mean()), float(level[mu_true <= 0.2].mean())
    check(hi - lo >= 0.5, f"single group: mean level over high stretches {hi:.3f} vs low {lo:.3f}")
    stats = {
        "sites": T, "logZ": log_z, "wall_s": wall, "sites_per_s": T / wall,
        "ms_per_site": 1e3 * wall / T, "spill_count": spill,
        "level_high": hi, "level_low": lo, "launches_per_site": launches / (T - 1),
        "max_memory_allocated_bytes": (torch.cuda.max_memory_allocated(device)
                                       if device.type == "cuda" else None),
    }
    print(f"single group: T={T} N={SG_N} M_cap={SG_N - R} logZ={log_z:.3f} launches={launches} "
          f"spills={spill} {wall:.2f} s, {stats['sites_per_s']:.1f} sites/s, "
          f"{stats['ms_per_site']:.3f} ms/site, mean level high {hi:.3f} vs low {lo:.3f}, "
          f"max_memory_allocated {stats['max_memory_allocated_bytes']}")
    return stats, launches


def slice_phase(device, root, data_dir, sg_dir, dmr, segment_size, buffer_size, seed=0):
    """Run the infer verb through the CLI on the seeded chromosome and the
    estimated theta, and check its outputs. Returns (stats dict, kernel
    launches in the run)."""
    import numpy as np
    import torch
    from hygeia_tpu_torch import cli
    from hygeia_tpu_torch.ops.cuda_resampling import KERNEL

    n_sites = segment_size + buffer_size
    dmr = dmr[:n_sites]  # batch 0's window
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
    check(launches == T - 1, f"kernel launched {launches} times for T={T} sites")
    split = arrays[f"optimal_split_probs_{N}_{seed}.npz"]
    regime = arrays[f"optimal_regime_probs_{N}_{seed}.npz"]
    check(bool(np.all(np.isfinite(split))) and bool(np.all(np.isfinite(regime))), "non-finite probabilities")
    check(np.allclose(regime[:, :R].sum(1), 1, atol=1e-5), "control regime probabilities do not sum to 1")
    in_dmr, out_dmr = float(split[dmr].mean()), float(split[~dmr].mean())
    check(in_dmr > out_dmr, f"split probability inside DMRs {in_dmr:.3f} <= outside {out_dmr:.3f}")
    stats = {
        "sites": T, "logZ": log_z, "filter_s": t_f, "backward_s": t_b, "wall_s": wall,
        "sites_per_s": T / (t_f + t_b), "split_in_dmr": in_dmr, "split_outside": out_dmr,
        "launches_per_site": launches / (T - 1),
        "max_memory_allocated_bytes": (torch.cuda.max_memory_allocated(device)
                                       if device.type == "cuda" else None),
    }
    print(f"slice: T={T} N={N} B={B} logZ={log_z:.3f} launches={launches} "
          f"filter {t_f:.2f} s, backward {t_b:.2f} s, {stats['sites_per_s']:.1f} sites/s, "
          f"split prob in DMRs {in_dmr:.3f} vs outside {out_dmr:.3f}, "
          f"max_memory_allocated {stats['max_memory_allocated_bytes']}")
    return stats, launches


def streamed_phase(device, root, data_dir, sg_dir, segment_size, buffer_size, mono, block, seed=0):
    """infer --streaming_blocks ``block`` on phase 7's window and seed, through
    runner.infer_segment as the CLI calls it (with its per-block timings):
    the same files as phase 7 bit for bit. Returns (stats, launches)."""
    import numpy as np
    import torch
    from hygeia_tpu_torch.ops.cuda_resampling import KERNEL
    from hygeia_tpu_torch.two_group.runner import infer_segment
    from hygeia_tpu_torch.two_group.streaming import block_bounds, launches_per_call

    T, N = segment_size + buffer_size, 50 * (2 * R + R * R)
    results = os.path.join(root, "results_streamed")
    torch.cuda.reset_peak_memory_stats(device)
    KERNEL.launches = 0
    tim = {}
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        log_z = infer_segment(data_dir=data_dir, single_group_dir=sg_dir, results_dir=results, chrom="1",
                              device=device, batch=0, seed=seed, segment_size=segment_size,
                              buffer_size=buffer_size, streaming_blocks=block, timings=tim)[N]
    wall = time.perf_counter() - t0
    launches = KERNEL.launches
    peak = torch.cuda.max_memory_allocated(device)
    print(out.getvalue().strip())

    a_dir, b_dir = os.path.join(root, "results", "chrom_1_0"), os.path.join(results, "chrom_1_0")
    names = sorted(n for n in os.listdir(a_dir) if n.endswith(".npz"))
    check(names == sorted(n for n in os.listdir(b_dir) if n.endswith(".npz")), "streamed: other npz files")
    for name in names:
        a, b = np.load(os.path.join(a_dir, name))["arr_0"], np.load(os.path.join(b_dir, name))["arr_0"]
        check(a.dtype == b.dtype and np.array_equal(a, b), f"streamed: {name} differs from the monolithic run")
    check(f"seed {seed}: degenerate_steps=0" in out.getvalue(), "streamed: degenerate filter steps")
    check(math.isclose(log_z, mono["logZ"], rel_tol=1e-5), f"streamed: logZ {log_z} vs {mono['logZ']}")
    reruns = tim["rerun_equals_checkpoint"][0]
    bounds = block_bounds(T, block)
    check(len(reruns) == len(bounds) - 1 and all(reruns), f"streamed: re-runs equal to checkpoints {reruns}")
    want = launches_per_call(T, block)
    check(launches == want, f"streamed: kernel launched {launches} times, 2T - len_last - 2 = {want}")
    check(peak < mono["max_memory_allocated_bytes"] / 2,
          f"streamed: peak {peak} bytes, not below half of the monolithic {mono['max_memory_allocated_bytes']}")
    pull = tim["pull"][0]
    stats = {
        "sites": T, "blocks": [hi - lo for lo, hi in bounds], "logZ": log_z,
        "logZ_equal_bitwise": log_z == mono["logZ"], "wall_s": wall,
        "fwd_s": sum(tim["fwd"][0]), "rev_s": sum(tim["rev"][0]), "pull_s_per_block": pull,
        "sites_per_s": T / wall, "launches_per_site": launches / T,
        "max_memory_allocated_bytes": peak,
    }
    print(f"streamed: T={T} W={block} blocks {stats['blocks']}: npz arrays equal to the monolithic "
          f"run bit for bit, logZ {log_z:.3f} (bitwise equal: {stats['logZ_equal_bitwise']}), re-runs equal "
          f"to checkpoints, launches={launches}; forward {stats['fwd_s']:.2f} s, reverse {stats['rev_s']:.2f} s, "
          f"wall {wall:.2f} s; device-to-host copy per block {[round(x, 6) for x in pull]} s; "
          f"max_memory_allocated {peak} (monolithic {mono['max_memory_allocated_bytes']})")
    return stats, launches


def chromosome_phase(device, root, n_sites, seed=1):
    """infer_chromosome_streamed on a second seeded chromosome "2" with phase
    6's theta. Returns (stats, launches)."""
    import numpy as np
    import torch
    from hygeia_tpu_torch.ops.cuda_resampling import KERNEL
    from hygeia_tpu_torch.two_group.runner import infer_chromosome_streamed, segment_window
    from hygeia_tpu_torch.two_group.streaming import launches_per_call

    data_dir, sg_dir, dmr, _ = make_dataset(root, n_sites, seed=seed, chrom="2")
    shutil.copy(os.path.join(sg_dir, "theta_1.csv.gz"), os.path.join(sg_dir, "theta_2.csv.gz"))
    seg, buf, seeds, W = (CHROM2[k] for k in ("segment_size", "buffer_size", "seeds", "block"))
    results = os.path.join(root, "results_chrom")
    torch.cuda.reset_peak_memory_stats(device)
    KERNEL.launches = 0
    tim = {}
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        log_z = infer_chromosome_streamed(data_dir=data_dir, single_group_dir=sg_dir, results_dir=results,
                                          chrom="2", device=device, seed=seeds, segment_size=seg,
                                          buffer_size=buf, streaming_blocks=W, timings=tim)
    wall = time.perf_counter() - t0
    launches = KERNEL.launches
    text = out.getvalue()

    N, B = 50 * (2 * R + R * R), 25
    split_sum = {True: 0.0, False: 0.0}
    split_n = {True: 0, False: 0}
    batches = sorted(log_z)
    for batch in batches:
        sl, ret = segment_window(n_sites, batch, seg, buf)
        t_w, n_ret = len(sl), len(ret)
        path = os.path.join(results, f"chrom_2_{batch}")
        for s in seeds:
            check(math.isfinite(log_z[batch][s][N]), f"chromosome: batch {batch} seed {s} logZ not finite")
            check(f"batch {batch} seed {s}: degenerate_steps=0" in text,
                  f"chromosome: batch {batch} seed {s} degenerate filter steps")
            expect = {
                f"optimal_backward_particles_merged_state_{N}_{s}.npz": ((n_ret, B), np.int16),
                f"optimal_backward_particles_control_state_{N}_{s}.npz": ((n_ret, B, 2), np.int32),
                f"optimal_backward_particles_case_state_{N}_{s}.npz": ((n_ret, B, 2), np.int32),
                f"optimal_split_probs_{N}_{s}.npz": ((t_w,), np.float32),
                f"optimal_regime_probs_{N}_{s}.npz": ((t_w, 2 * R), np.float32),
            }
            for name, (shape, dtype) in expect.items():
                arr = np.load(os.path.join(path, name))["arr_0"]
                check(arr.shape == shape and arr.dtype == dtype,
                      f"chromosome: batch {batch} {name}: {arr.shape} {arr.dtype}, expected {shape} {dtype}")
            for name in (f"flags{s}.txt", f"log_normalizing_constants_optimal_{s}.txt",
                         f"optimal_time_{s}.txt", f"optimal_time_backward_{s}.txt"):
                check(os.path.exists(os.path.join(path, name)), f"chromosome: batch {batch} missing {name}")
            split = np.load(os.path.join(path, f"optimal_split_probs_{N}_{s}.npz"))["arr_0"][ret]
            in_dmr = dmr[sl.start + ret.start : sl.start + ret.stop]
            for flag in (True, False):
                split_sum[flag] += float(split[in_dmr == flag].sum())
                split_n[flag] += int((in_dmr == flag).sum())
        for name in ("observations_control", "observations_case", "n_total_reads_control",
                     "n_total_reads_case", "positions"):
            check(os.path.exists(os.path.join(path, f"{name}.csv.gz")), f"chromosome: missing {name}.csv.gz")
    in_dmr, out_dmr = split_sum[True] / split_n[True], split_sum[False] / split_n[False]
    check(in_dmr > out_dmr, f"chromosome: split probability in DMRs {in_dmr:.3f} <= outside {out_dmr:.3f}")
    chunks = tim["chunks"]
    want = sum(launches_per_call(t_w, W) for t_w, _, _, _ in chunks)
    check(launches == want, f"chromosome: kernel launched {launches} times, the per-chunk formula gives {want}")
    # One chunk a window length, of all its (batch, seed) units: 2, 8 and 2
    # at the default 11,000 CpGs.
    groups = {}
    for batch in batches:
        t_w = len(segment_window(n_sites, batch, seg, buf)[0])
        groups[t_w] = groups.get(t_w, 0) + len(seeds)
    got_chunks = sorted((t_w, units) for t_w, units, _, _ in chunks)
    check(got_chunks == sorted(groups.items()), f"chromosome: chunks {got_chunks}, expected {sorted(groups.items())}")
    unit_sites = sum(t_w * units for t_w, units, _, _ in chunks)
    stats = {
        "sites": n_sites, "batches": len(batches), "seeds": list(seeds), "block": W,
        "chunks": [{"window": t_w, "units": u, "seconds": sec, "pull_s_per_block": t["pull"]}
                   for t_w, u, sec, t in chunks],
        "wall_s": wall, "unit_sites_per_s": unit_sites / wall,
        "launches_per_site": launches / sum(t_w for t_w, _, _, _ in chunks),
        "split_in_dmr": in_dmr, "split_outside": out_dmr,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(device),
    }
    print(f"chromosome: {n_sites} CpGs, {len(batches)} batches x seeds {list(seeds)}, W={W}: chunks "
          f"{[(c['window'], c['units'], round(c['seconds'], 2)) for c in stats['chunks']]} (window, units, s); "
          f"launches={launches}; {stats['unit_sites_per_s']:.1f} sites x units per s; split prob in DMRs "
          f"{in_dmr:.3f} vs outside {out_dmr:.3f}; max_memory_allocated {stats['max_memory_allocated_bytes']}")
    return stats, launches


def robust_phase(device, root, data_dir, sg_dir, dmr, segment_size, buffer_size, seed=0):
    """infer --robust through the CLI on batch 0 of phase 5's chromosome
    (segment ``segment_size`` + halo ``buffer_size``, one seed, phase 6's
    theta): the robust table built on the card against the float64 table on
    the CPU (rtol 1e-5, float32), and the run against a non-robust run of
    the same window. Returns (stats, launches of the robust run)."""
    import numpy as np
    import torch
    from hygeia_tpu_torch import cli
    from hygeia_tpu_torch.ops.cuda_resampling import KERNEL
    from hygeia_tpu_torch.ops.distributions import mu_sigma_to_alpha_beta
    from hygeia_tpu_torch.ops.emissions import robust_emission_log_prob_table
    from hygeia_tpu_torch.utils import io as hio

    T, N = segment_size + buffer_size, 50 * (2 * R + R * R)
    y = hio.read_count_matrix(os.path.join(data_dir, "n_methylated_reads_control_1.txt.gz"))[:T]
    n = hio.read_count_matrix(os.path.join(data_dir, "n_total_reads_control_1.txt.gz"))[:T]
    tables = []
    for dev, dtype in ((torch.device("cpu"), torch.float64), (torch.device("cpu"), torch.float32),
                       (device, torch.float32)):
        a, b = mu_sigma_to_alpha_beta(torch.tensor(MU, dtype=dtype, device=dev),
                                      torch.tensor(SIGMA, dtype=dtype, device=dev))
        tables.append(robust_emission_log_prob_table(y, n, a, b, dtype=dtype).cpu())
    check(torch.equal(tables[1], tables[2]),
          f"robust: the card's f32 table differs from the CPU's on {int((tables[1] != tables[2]).sum())} entries")
    rel = float(((tables[2].double() - tables[0]).abs() / tables[0].abs()).max())
    check(rel <= 1e-5, f"robust: the card's f32 table is {rel:.3g} off the f64 CPU table (rtol 1e-5)")

    def run(name, extra):
        argv = ["infer", "--data_dir", data_dir, "--single_group_dir", sg_dir, "--results_dir",
                os.path.join(root, name), "--chrom", "1", "--segment_size", str(segment_size),
                "--buffer_size", str(buffer_size), "--batch", "0", "--seed", str(seed),
                "--device", str(device), *extra]
        KERNEL.launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            log_z = cli.main(argv)[N]
        return log_z, time.perf_counter() - t0, KERNEL.launches, out.getvalue()

    log_z, wall, launches, text = run("results_robust", ["--robust"])
    plain_log_z, plain_wall, _, _ = run("results_robust_plain", [])
    path = os.path.join(root, "results_robust", "chrom_1_0")
    split = np.load(os.path.join(path, f"optimal_split_probs_{N}_{seed}.npz"))["arr_0"]
    check(math.isfinite(log_z), f"robust: logZ not finite: {log_z}")
    check(log_z != plain_log_z, "robust: logZ equals the non-robust run's")
    check(f"seed {seed}: degenerate_steps=0" in text, "robust: degenerate filter steps")
    check(launches == T - 1, f"robust: kernel launched {launches} times for T={T} sites")
    check("--robust=True" in open(os.path.join(path, f"flags{seed}.txt")).read(), "robust: flags lack --robust")
    in_dmr, out_dmr = float(split[dmr[:T]].mean()), float(split[~dmr[:T]].mean())
    check(in_dmr > out_dmr, f"robust: split probability in DMRs {in_dmr:.3f} <= outside {out_dmr:.3f}")
    stats = {"sites": T, "logZ": log_z, "logZ_plain": plain_log_z, "wall_s": wall, "plain_wall_s": plain_wall,
             "table_max_rel_err": rel, "split_in_dmr": in_dmr, "split_outside": out_dmr,
             "launches_per_site": launches / (T - 1)}
    print(f"robust: T={T} f32 table on the card equal to the CPU's bit for bit, {rel:.3g} max rel from the f64 "
          f"table; logZ {log_z:.3f} (BetaBinomial "
          f"{plain_log_z:.3f}); launches={launches}; {wall:.2f} s (BetaBinomial {plain_wall:.2f} s); split prob "
          f"in DMRs {in_dmr:.3f} vs outside {out_dmr:.3f}")
    return stats, launches


def blocked_phase(device, root, regime, block_size, halo, warmup_sites, seed=0):
    """single_group.blocked on phase 5's control CpGs at the CLI's defaults
    (phase 6's model, theta_init and generator seed), then the engine's ms
    per site at U = 1, 8 and 48. Returns (stats, launches of the blocked
    call)."""
    import numpy as np
    import torch
    from hygeia_tpu_torch.ops.cuda_resampling import KERNEL
    from hygeia_tpu_torch.ops.emissions import emission_log_prob_table
    from hygeia_tpu_torch.single_group.blocked import run_online_combined_inference_blocked
    from hygeia_tpu_torch.single_group.engine import EngineConfig, run_online_combined_inference
    from hygeia_tpu_torch.single_group.model import make_model, theta_to_parameters
    from hygeia_tpu_torch.utils import io as hio

    sg_in, sg_dir = os.path.join(root, "single_group_input"), os.path.join(root, "single_group")
    n_meth = hio.read_headed_matrix(os.path.join(sg_in, "n_methylated_reads_1.csv")).T
    n_total = hio.read_headed_matrix(os.path.join(sg_in, "n_total_reads_1.csv")).T
    T = n_total.shape[0]
    model = make_model(SG_MU, SG_SIGMA, 2, [2.0] * R, device=device)
    E = emission_log_prob_table(n_meth, n_total, model.alpha, model.beta)
    theta0 = torch.randn((model.dim_theta,), generator=torch.Generator().manual_seed(seed), dtype=torch.float64)
    cfg = EngineConfig(n_particles_max=SG_N, estimate_regimes=True, estimate_parameters=True)
    tim = {}
    KERNEL.launches = 0
    t0 = time.perf_counter()
    res = run_online_combined_inference_blocked(
        model, theta0.numpy(), E, cfg, block_size=block_size, halo=halo, warmup_sites=warmup_sites,
        generator=torch.Generator(device=device).manual_seed(seed), timings=tim)
    wall = time.perf_counter() - t0
    launches = KERNEL.launches
    n_blocks, win, Tw = -(-T // block_size), block_size + halo, min(T, warmup_sites)
    check(n_blocks >= 2 and T >= win, f"blocked: {T} sites make {n_blocks} blocks of {block_size}")
    want = (Tw - 1) + (win - 1)
    check(launches == want, f"blocked: kernel launched {launches} times, (Tw - 1) + (win - 1) = {want}")
    probs, trace = res.regime_probs, res.theta_trace
    check(probs.shape == (T, R) and bool(np.isfinite(probs).all()), "blocked: regime probabilities")
    check(np.allclose(probs.sum(1), 1, atol=1e-4), "blocked: regime probabilities do not sum to 1")
    check(bool(np.isfinite(trace).all()) and math.isfinite(res.log_normalizing_constant), "blocked: non-finite")
    # The warmup takes the draws of phase 6's generator: its trace is phase
    # 6's first Tw rows bit for bit.
    seq_trace = hio.read_headed_table(os.path.join(sg_dir, "theta_trace_1.csv"))[1].astype(np.float32)
    check(np.array_equal(trace[:Tw], seq_trace[:Tw]), "blocked: the warmup's trace is not phase 6's prefix")
    seq_probs = hio.read_headed_table(os.path.join(sg_dir, "regime_probs_1.csv"))[1][:, 1:]
    conf = (probs.max(1) > 0.9) | (seq_probs.max(1) > 0.9)
    agree = float((probs.argmax(1) == seq_probs.argmax(1))[conf].mean())
    check(agree > 0.95, f"blocked: regime modes agree with the sequential run on {agree:.3f} of confident sites")
    # The final theta lies nearer phase 6's than the start does, in P and in
    # omega (max |difference|): both chains moved the same way.
    fin_b, fin_s, start = (theta_to_parameters(np.asarray(th, np.float64), R)
                           for th in (trace[-1], seq_trace[-1], theta0.numpy()))
    d_omega = float(np.abs(fin_b["omega"] - fin_s["omega"]).max())
    d_p = float(np.abs(fin_b["p"] - fin_s["p"]).max())
    d0_omega = float(np.abs(start["omega"] - fin_s["omega"]).max())
    d0_p = float(np.abs(start["p"] - fin_s["p"]).max())
    check(d_omega < d0_omega and d_p < d0_p,
          f"blocked: final theta |omega diff| {d_omega:.3g} (start {d0_omega:.3g}), |P diff| {d_p:.3g} "
          f"(start {d0_p:.3g}) from phase 6's")
    level = probs @ np.asarray(SG_MU)
    mu_true = np.asarray(MU)[regime]
    hi, lo = float(level[mu_true >= 0.8].mean()), float(level[mu_true <= 0.2].mean())
    check(hi - lo >= 0.5, f"blocked: mean level over high stretches {hi:.3f} vs low {lo:.3f}")

    sweep = {}
    for units in (1, 8, 48):
        E_u = E[:300].expand(units, 300, R).contiguous()
        gen = torch.Generator(device=device).manual_seed(seed)
        run_online_combined_inference(model, theta0.numpy(), E_u[:, :20], cfg, n_units=units, generator=gen)
        _sync(device)
        t1 = time.perf_counter()
        run_online_combined_inference(model, theta0.numpy(), E_u, cfg, n_units=units, generator=gen)
        _sync(device)
        sweep[units] = 1e3 * (time.perf_counter() - t1) / 299
    stats = {"sites": T, "blocks": n_blocks, "window": win, "warmup_sites": Tw, "wall_s": wall,
             "warmup_s": tim["warmup_s"], "blocks_s": tim["blocks_s"], "mode_agreement": agree,
             "confident_sites": int(conf.sum()), "d_omega": d_omega, "d_p": d_p, "d_omega_start": d0_omega,
             "d_p_start": d0_p, "level_high": hi,
             "level_low": lo, "logZ_windows": res.log_normalizing_constant,
             "ms_per_site_by_units": sweep, "launches_per_site": launches / (T - 1)}
    print(f"blocked: T={T} in {n_blocks} blocks of {block_size} + halo {halo}, warmup {Tw}: launches={launches}; "
          f"warmup {tim['warmup_s']:.2f} s, blocks {tim['blocks_s']:.2f} s, wall {wall:.2f} s; warmup trace = "
          f"phase 6's prefix; modes agree on {agree:.3f} of {int(conf.sum())} confident sites; final theta "
          f"|omega diff| {d_omega:.3g} (start {d0_omega:.3g}), |P diff| {d_p:.3g} (start {d0_p:.3g}); level high {hi:.3f} vs low {lo:.3f}; engine ms/site "
          f"over 300 sites at U=1, 8, 48: {', '.join(f'{v:.3f}' for v in sweep.values())}")
    return stats, launches


def pipeline_phase(device, root, n_sites, batch_size=6000, buffer_size=600, seeds=2):
    """run --two_group through the CLI from BED files of a third seeded
    chromosome "3", then again to check that nothing runs twice. Returns
    (stats, launches of the first run)."""
    import numpy as np
    from hygeia_tpu_torch import cli
    from hygeia_tpu_torch.ops.cuda_resampling import KERNEL
    from hygeia_tpu_torch.two_group.runner import segment_window
    from hygeia_tpu_torch.utils import io as hio

    cpg, controls, cases, dmr, pos0 = make_bed_dataset(os.path.join(root, "bed"), n_sites, chrom="3")
    out = os.path.join(root, "pipeline")
    argv = ["run", "--two_group", "--output_dir", out, "--chroms", "3", "--cpg_file_path", cpg,
            "--batch_size", str(batch_size), "--buffer_size", str(buffer_size),
            "--num_of_inference_seeds", str(seeds), "--device", str(device)]
    for flag, paths, prefix in (("control", controls, "c"), ("case", cases, "k")):
        for i, p in enumerate(paths):
            argv += [f"--{flag}_data_path", p, f"--{flag}_id_names", f"{prefix}{i}"]
    KERNEL.launches = 0
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        cli.main(argv)
    wall = time.perf_counter() - t0
    launches = KERNEL.launches

    N, B = 50 * (2 * R + R * R), 25
    n_batches = 1 + n_sites // batch_size
    windows = [len(segment_window(n_sites, b, batch_size, buffer_size)[0]) for b in range(n_batches)]
    check(all(w > 0 for w in windows), f"pipeline: an empty batch in {windows}")
    want = (n_sites - 1) + sum(w - 1 for w in windows)
    check(launches == want, f"pipeline: kernel launched {launches} times, (T - 1) + sum(window - 1) = {want}")
    names = [f"1_PREPROCESS/3/{n}_3.txt.gz" for n in ("positions", "cpg_sites_merged", "n_methylated_reads_control",
                                                      "n_total_reads_control", "n_methylated_reads_case",
                                                      "n_total_reads_case")]
    names += [f"2_ESTIMATE_PARAMETERS_AND_REGIMES/3/{n}_3.csv.gz" for n in ("theta", "theta_trace", "p", "omega",
                                                                           "kappa", "regime_probabilities")]
    names += ["3_GET_CHROM_SEGMENTS/3/chrom_segments_3.csv"]
    for b in range(n_batches):
        names += [f"4_INFER/chrom_3_{b}/optimal_backward_particles_{k}_state_{N}_{s}.npz"
                  for k in ("merged", "control", "case") for s in range(seeds)]
        names += [f"4_INFER/unit_3_{b}/.done"]
    names += [f"5_AGGREGATE_RESULTS/3/{n}" for n in (
        "split_probs_3.csv.gz", "merge_states_chrom_3.csv.gz", "control_regimes_chrom_3.csv.gz",
        "case_regimes_chrom_3.csv.gz", "control_durations_chrom_3.csv.gz", "case_durations_chrom_3.csv.gz",
        "n_total_reads_control_chrom_3.csv.gz", "n_total_reads_case_chrom_3.csv.gz",
        "n_meth_reads_control_chrom_3.csv.gz", "n_meth_reads_case_chrom_3.csv.gz")]
    names += [f"6_GET_DMPS/3/{p}dmp_{t}.csv" for p in ("", "weighted_") for t in (0.01, 0.05)]
    names += ["trace.tsv", "versions.yml", "timeline.html", "report.html", "dag.dot"]
    for name in names:
        check(os.path.exists(os.path.join(out, name)), f"pipeline: missing {name}")
    agg = os.path.join(out, "5_AGGREGATE_RESULTS", "3")
    for name in ("control_regimes_chrom_3.csv.gz", "case_regimes_chrom_3.csv.gz", "merge_states_chrom_3.csv.gz"):
        header, index, table = hio.read_int_table(os.path.join(agg, name))
        check(table.shape == (n_sites, seeds * B) and header[0] == "pos", f"pipeline: {name} {table.shape}")
    check(np.array_equal(index, pos0), "pipeline: the aggregate index is not the CpG positions")
    rows = [r.split("\t") for r in open(os.path.join(out, "trace.tsv")).read().splitlines()[1:]]
    check(all(r[5] == "ok" for r in rows), f"pipeline: stages not ok: {rows}")
    stage_s = {f"{r[0]}": float(r[2]) for r in rows}
    with open(os.path.join(out, "6_GET_DMPS", "3", "weighted_dmp_0.05.csv")) as f:
        lines = f.read().splitlines()
    called = np.array([int(ln.split(",")[1]) for ln in lines[1:]], np.int64)
    check(called.size > 0, "pipeline: weighted_dmp_0.05.csv is empty")
    site = np.searchsorted(pos0, called)
    precision = float(dmr[site].mean())
    recall = float(np.isin(np.flatnonzero(dmr), site).mean())
    check(precision >= 0.5, f"pipeline: {precision:.3f} of the called DMPs lie in planted windows")

    t1 = time.perf_counter()
    KERNEL.launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(argv)
    wall2 = time.perf_counter() - t1
    rows2 = [r.split("\t") for r in open(os.path.join(out, "trace.tsv")).read().splitlines()[1:]]
    check(KERNEL.launches == 0 and all(r[3] == "True" for r in rows2),
          f"pipeline: the resumed run ran stages again ({KERNEL.launches} launches, {rows2})")
    check(wall2 < 0.1 * wall, f"pipeline: the resumed run took {wall2:.2f} s of the first's {wall:.2f} s")
    stats = {"sites": n_sites, "batches": n_batches, "windows": windows, "seeds": seeds, "wall_s": wall,
             "stage_s": stage_s, "dmps_weighted_0.05": int(called.size), "precision": precision, "recall": recall,
             "resumed_wall_s": wall2, "launches_per_site": launches / (n_sites - 1 + sum(w - 1 for w in windows))}
    print(f"pipeline: {n_sites} CpGs from BED files, {n_batches} batches x {seeds} seeds: launches={launches}; "
          f"{wall:.2f} s, by stage {stage_s}; weighted_dmp_0.05: {called.size} positions, {precision:.3f} in planted "
          f"windows, recall {recall:.3f}; resumed run {wall2:.2f} s, no stage again")
    return stats, launches


def sg_pipeline_phase(device, root, n_sites):
    """run (the single-group pipeline) through the CLI from a sample sheet of
    the two control BED files of a fourth seeded chromosome "4", at the run
    verb's defaults (R=6, N=250 so M=244, u=3, d_max 4096, f32): both
    batched passes with U=2, so 2 (T - 1) launches; the regime modes on the
    planted high and low stretches; a tabix query against a plain scan;
    make_bed_file on the stage's regime file against the stage's bytes; a
    re-run that runs no stage. Then preprocess --format gembs on the same
    samples' counts written as gemBS tab files. Returns (stats, launches of
    the first run)."""
    import gzip

    import numpy as np
    from hygeia_tpu_torch import cli
    from hygeia_tpu_torch.ops.cuda_resampling import KERNEL
    from hygeia_tpu_torch.utils import io as hio
    from hygeia_tpu_torch.utils.tabix import TabixFile

    bed_root = os.path.join(root, "bed4")
    cpg, controls, _cases, _dmr, pos0, regime = make_bed_dataset(bed_root, n_sites, seed=4, chrom="4",
                                                                 with_regime=True)
    sheet = os.path.join(bed_root, "samples.csv")
    samples = ["s0", "s1"]
    with open(sheet, "w") as f:
        f.write("id,file\n" + "".join(f"{sid},{p}\n" for sid, p in zip(samples, controls)))
    out = os.path.join(root, "sg_pipeline")
    argv = ["run", "--output_dir", out, "--chroms", "4", "--cpg_file_path", cpg, "--sample_sheet", sheet,
            "--device", str(device)]
    KERNEL.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(argv)
    wall = time.perf_counter() - t0
    launches = KERNEL.launches

    T = n_sites
    check(launches == 2 * (T - 1), f"single-group pipeline: kernel launched {launches} times, 2 (T - 1) = "
                                   f"{2 * (T - 1)}")
    rows = [r.split("\t") for r in open(os.path.join(out, "trace.tsv")).read().splitlines()[1:]]
    stage_s = {f"{r[0]}[{r[1]}]": float(r[2]) for r in rows}
    check(all(r[5] == "ok" for r in rows), f"single-group pipeline: stages not ok: {rows}")
    check({"ESTIMATE_PARAMETERS[batched]", "ESTIMATE_REGIMES[batched]"} <= {r[0] for r in rows},
          f"single-group pipeline: the batched passes did not run: {rows}")
    recovered = {}
    for sid in samples:
        names = [f"1_PREPROCESS/{sid}/4/{n}_4.txt.gz" for n in ("positions", "cpg_sites_merged",
                                                                "n_methylated_reads_case", "n_total_reads_case")]
        names += [f"2_ESTIMATE_PARAMETERS/{sid}/4/{n}_4.csv.gz" for n in ("theta", "theta_trace", "p", "omega",
                                                                         "kappa")]
        names += [f"3_ESTIMATE_REGIMES/{sid}/4/regime_probabilities_4.csv.gz",
                  f"4_SINGLE_GROUP_OUTPUT/{sid}/{sid}_regimes_4.bed.gz",
                  f"4_SINGLE_GROUP_OUTPUT/{sid}/{sid}_regimes_4.bed.gz.tbi"]
        for name in names:
            check(os.path.exists(os.path.join(out, name)), f"single-group pipeline: missing {name}")
        check(not os.path.exists(os.path.join(out, f"2_ESTIMATE_PARAMETERS/{sid}/4/regime_probabilities_4.csv.gz")),
              "single-group pipeline: the parameter pass wrote regime probabilities")
        reg_file = os.path.join(out, f"3_ESTIMATE_REGIMES/{sid}/4/regime_probabilities_4.csv.gz")
        header, probs = hio.read_headed_table(reg_file)
        check(probs.shape == (T, 1 + R) and np.array_equal(probs[:, 0], pos0),
              f"single-group pipeline: {sid} regime table {probs.shape}")
        recovered[sid] = _recovered(probs[:, 1:], regime)
        bed_gz = os.path.join(out, f"4_SINGLE_GROUP_OUTPUT/{sid}/{sid}_regimes_4.bed.gz")
        recs = [ln.split("\t") for ln in gzip.decompress(open(bed_gz, "rb").read()).decode().splitlines()]
        check(len(recs) == T, f"single-group pipeline: {sid} BED has {len(recs)} records")
        lo, hi = int(recs[T // 3][1]), int(recs[T // 3 + 200][2])
        hits = list(TabixFile(bed_gz).query("4", lo, hi))
        scan = [r for r in recs if int(r[1]) < hi and int(r[2]) > lo]
        check(len(hits) == len(scan) and len(hits) > 0,
              f"single-group pipeline: tabix query gave {len(hits)} records, a plain scan {len(scan)}")
        remade = os.path.join(root, f"remade_{sid}.bed")
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["make_bed_file", "--chr", "4", "--regimes_file", reg_file, "--output_file", remade,
                      "--bgzip"])
        for ext in ("", ".tbi"):
            check(open(remade + ".gz" + ext, "rb").read() == open(bed_gz + ext, "rb").read(),
                  f"single-group pipeline: make_bed_file differs from the stage's .bed.gz{ext}")

    t1 = time.perf_counter()
    KERNEL.launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(argv)
    wall2 = time.perf_counter() - t1
    rows2 = [r.split("\t") for r in open(os.path.join(out, "trace.tsv")).read().splitlines()[1:]]
    check(KERNEL.launches == 0 and rows2 and all(r[3] == "True" for r in rows2),
          f"single-group pipeline: the resumed run ran stages again ({KERNEL.launches} launches, {rows2})")

    # The same samples' counts as gemBS tab files (chr-prefixed contigs).
    gembs_dir = os.path.join(root, "gembs")
    os.makedirs(gembs_dir, exist_ok=True)
    gcpg = os.path.join(gembs_dir, "cpg.tsv")
    with open(gcpg, "w") as f:
        f.write("seqID\tstart\n" + "".join(f"chr4\t{p + 1}\n" for p in pos0))
    gargv = ["preprocess", "--cpg_file_path", gcpg, "--output_path", os.path.join(gembs_dir, "out"),
             "--chromosome", "4", "--format", "gembs"]
    want = {}
    for sid in samples:
        pre = os.path.join(out, f"1_PREPROCESS/{sid}/4")
        meth = hio.read_count_matrix(os.path.join(pre, "n_methylated_reads_case_4.txt.gz"))[:, 0]
        total = hio.read_count_matrix(os.path.join(pre, "n_total_reads_case_4.txt.gz"))[:, 0]
        want[sid] = (meth, total)
        path = os.path.join(gembs_dir, f"{sid}.tsv")
        with open(path, "w") as f:
            f.write(f"Contig\tPos0\tRef\t{sid}:non_conv\t{sid}:conv\n")
            for p, m, t in zip(pos0, meth, total):
                if t > 0:
                    f.write(f"chr4\t{p}\tCG\t{int(m)}\t{int(t - m)}\n")
            f.write(f"chr5\t{pos0[0]}\tCG\t9\t9\nchr4\t{pos0[1]}\tCA\t9\t9\n")  # filtered rows
        gargv += ["--control_data_path", path, "--control_id_names", sid]
    t2 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(gargv)
    gembs_s = time.perf_counter() - t2
    gout = os.path.join(gembs_dir, "out")
    check(np.array_equal(hio.read_positions(os.path.join(gout, "positions_4.txt.gz")), pos0),
          "gemBS preprocess: positions differ from the CpG list")
    gm = hio.read_count_matrix(os.path.join(gout, "n_methylated_reads_control_4.txt.gz"))
    gt = hio.read_count_matrix(os.path.join(gout, "n_total_reads_control_4.txt.gz"))
    for i, sid in enumerate(samples):
        check(np.array_equal(gm[:, i], want[sid][0]) and np.array_equal(gt[:, i], want[sid][1]),
              f"gemBS preprocess: {sid}'s counts differ from the ones written")

    # The same preprocessed directories (the samples= form) with the
    # learning settings of tests/test_orchestrator.py's single-group run
    # (an update every 50 sites at 20 times the rate). At the CLI's
    # defaults the regime pass from the port's start draw stays in regime
    # 0 once its float32 hazard is 0 (no exit latch), in the JAX package
    # too, so the recovery above is printed, not held.
    from hygeia_tpu_torch.pipeline.orchestrator import run_single_group

    KERNEL.launches = 0
    t3 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out2 = run_single_group(output_dir=os.path.join(root, "sg_pipeline_learn"), chroms=["4"], device=device,
                                samples=[(sid, os.path.join(out, f"1_PREPROCESS/{sid}/4")) for sid in samples],
                                mu=MU, sigma=SIGMA, u=3, n_steps_without_parameter_update=50,
                                learning_rate_factor=0.2)
    learn_s = time.perf_counter() - t3
    launches2 = KERNEL.launches
    check(launches2 == 2 * (T - 1), f"single-group pipeline (samples=): kernel launched {launches2} times, "
                                    f"2 (T - 1) = {2 * (T - 1)}")
    learned = {}
    for sid in samples:
        _, probs = hio.read_headed_table(os.path.join(out2, f"3_ESTIMATE_REGIMES/{sid}/4/regime_probabilities_4.csv.gz"))
        learned[sid] = _recovered(probs[:, 1:], regime)
        check(learned[sid] > 0.6, f"single-group pipeline (samples=): {sid} recovers {learned[sid]:.3f} of the "
                                  "planted high and low stretches")

    stats = {"sites": T, "samples": len(samples), "wall_s": wall, "stage_s": stage_s,
             "recovered_high_low_cli_defaults": recovered, "recovered_high_low_learning": learned,
             "learning_run_s": learn_s, "resumed_wall_s": wall2, "gembs_preprocess_s": gembs_s,
             "launches_per_site": (launches + launches2) / (4 * (T - 1))}
    print(f"single-group pipeline: {T} CpGs x {len(samples)} samples from BED files: launches={launches}; "
          f"{wall:.2f} s, by stage {stage_s}; planted stretches recovered at the CLI defaults {recovered}; tabix "
          f"queries equal plain scans; make_bed_file equals the stage's bytes; resumed run {wall2:.2f} s, no stage "
          f"again; gemBS preprocess of the same counts {gembs_s:.2f} s, counts equal; samples= run with updates "
          f"every 50 sites at rate 0.2: launches={launches2}, {learn_s:.2f} s, planted stretches recovered {learned}")
    return stats, launches + launches2


def _recovered(probs, regime):
    """Share of the planted high (regime 0) and low (regime 1) stretches'
    sites whose most probable regime is the planted one."""
    planted = regime <= 1
    return float((probs.argmax(1)[planted] == regime[planted]).mean())


# Mean |marginal - backward-simulation| probability, phase 14 against phase
# 7 on the same sites: the split probability, and the 2R regime
# probabilities of every site. Each is about 2.3 times the larger of the
# two seeds' readings on an H100 (0.043 and 0.0295).
MARGINAL_SPLIT_BOUND = 0.1
MARGINAL_REGIME_BOUND = 0.07


def marginal_phase(device, root, data_dir, sg_dir, dmr, segment_size, buffer_size, slice_dir, slice_stats,
                   seeds=(0, 1), window=64):
    """infer --marginal (runner.infer_segment as the CLI calls it) on batch 0
    of phase 5's chromosome with phase 6's theta, both seeds in one call
    (M=50, N=2400, window 64): T - 1 launches, logZ finite, the spill count,
    the split probability higher inside the planted DMRs than outside, the
    split and the regime probabilities within MARGINAL_SPLIT_BOUND and
    MARGINAL_REGIME_BOUND (mean absolute) of phase 7's backward-simulation
    ones on the same sites; peak memory beside phase 7's. Returns (stats,
    launches)."""
    import numpy as np
    import torch
    from hygeia_tpu_torch.ops.cuda_resampling import KERNEL
    from hygeia_tpu_torch.two_group.runner import infer_segment

    T, N = segment_size + buffer_size, 50 * (2 * R + R * R)
    results = os.path.join(root, "results_marginal")
    torch.cuda.reset_peak_memory_stats(device)
    KERNEL.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        log_z = infer_segment(data_dir=data_dir, single_group_dir=sg_dir, results_dir=results, chrom="1",
                              device=device, batch=0, seed=list(seeds), segment_size=segment_size,
                              buffer_size=buffer_size, marginal=True, marginal_window=window)
    wall = time.perf_counter() - t0
    launches = KERNEL.launches
    peak = torch.cuda.max_memory_allocated(device)
    text = out.getvalue()
    print(text.strip())

    check(launches == T - 1, f"marginal: kernel launched {launches} times for T={T} sites (one call, both seeds)")
    path = os.path.join(results, "chrom_1_0")
    ref = np.load(os.path.join(slice_dir, f"optimal_split_probs_{N}_0.npz"))["arr_0"][:segment_size]
    ref_regime = np.load(os.path.join(slice_dir, f"optimal_regime_probs_{N}_0.npz"))["arr_0"][:segment_size]
    spills, diffs, regime_diffs, splits = {}, {}, {}, []
    for s in seeds:
        check(math.isfinite(log_z[s][N]), f"marginal: seed {s} logZ not finite: {log_z[s][N]}")
        check(f"seed {s}: degenerate_steps=0" in text, f"marginal: seed {s} degenerate filter steps")
        spill = [ln for ln in text.splitlines() if ln.startswith(f"marginal filter seed {s}: spill_count=")]
        check(len(spill) == 1, f"marginal: seed {s} printed no spill count")
        spills[s] = int(spill[0].split("=")[1].split()[0])
        split = np.load(os.path.join(path, f"optimal_split_probs_{N}_{s}.npz"))["arr_0"]
        regime = np.load(os.path.join(path, f"optimal_regime_probs_{N}_{s}.npz"))["arr_0"]
        check(split.shape == (segment_size,) and regime.shape == (segment_size, 2 * R),
              f"marginal: seed {s} shapes {split.shape} {regime.shape}")
        check(bool(np.isfinite(split).all()) and np.allclose(regime[:, :R].sum(1), 1, atol=1e-4),
              f"marginal: seed {s} probabilities not finite or not normalised")
        diffs[s] = float(np.abs(split - ref).mean())
        check(diffs[s] <= MARGINAL_SPLIT_BOUND, f"marginal: seed {s} split probabilities {diffs[s]:.4f} (mean abs) "
                                                f"from phase 7's, bound {MARGINAL_SPLIT_BOUND}")
        regime_diffs[s] = float(np.abs(regime - ref_regime).mean())
        check(regime_diffs[s] <= MARGINAL_REGIME_BOUND,
              f"marginal: seed {s} regime probabilities {regime_diffs[s]:.4f} (mean abs) from phase 7's, bound "
              f"{MARGINAL_REGIME_BOUND}")
        splits.append(split)
    split = np.mean(splits, axis=0)
    d = dmr[:segment_size]
    in_dmr, out_dmr = float(split[d].mean()), float(split[~d].mean())
    check(in_dmr > out_dmr, f"marginal: split probability inside DMRs {in_dmr:.3f} <= outside {out_dmr:.3f}")
    stats = {"sites": T, "seeds": list(seeds), "window": window, "logZ": {s: log_z[s][N] for s in seeds},
             "spill_count": spills, "wall_s": wall, "ms_per_site": 1e3 * wall / T,
             "split_mean_abs_diff_vs_slice": diffs, "regime_mean_abs_diff_vs_slice": regime_diffs,
             "split_in_dmr": in_dmr, "split_outside": out_dmr,
             "max_memory_allocated_bytes": peak, "slice_max_memory_allocated_bytes":
             slice_stats["max_memory_allocated_bytes"], "launches_per_site": launches / (T - 1)}
    print(f"marginal: T={T} seeds {list(seeds)} in one call, window {window}: launches={launches}; logZ "
          f"{[round(log_z[s][N], 3) for s in seeds]}; spills {spills}; {wall:.2f} s ({stats['ms_per_site']:.3f} "
          f"ms/site); split prob in DMRs {in_dmr:.3f} vs outside {out_dmr:.3f}; mean |split - phase 7's| {diffs} "
          f"(bound {MARGINAL_SPLIT_BOUND}); mean |regime - phase 7's| {regime_diffs} (bound {MARGINAL_REGIME_BOUND}); "
          f"max_memory_allocated {peak} (phase 7: "
          f"{slice_stats['max_memory_allocated_bytes']})")
    return stats, launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chrom_sites", type=int, default=40_000,
                    help="CpGs of the chromosome, all read by the single-group engine (default 40000)")
    ap.add_argument("--sites", type=int, default=10_000, help="infer's segment size (default 10000)")
    ap.add_argument("--buffer", type=int, default=1_000, help="infer's halo size (default 1000)")
    ap.add_argument("--stream_block", type=int, default=2048,
                    help="the streamed phase's --streaming_blocks (default 2048)")
    ap.add_argument("--chrom2_sites", type=int, default=11_000,
                    help="CpGs of the chromosome of the streamed chromosome phase (default 11000)")
    ap.add_argument("--robust_sites", type=int, default=3_000, help="robust infer's segment size (default 3000)")
    ap.add_argument("--robust_buffer", type=int, default=300, help="robust infer's halo size (default 300)")
    ap.add_argument("--theta_block", type=int, default=8192, help="blocked theta's block size (default 8192)")
    ap.add_argument("--theta_halo", type=int, default=1024, help="blocked theta's halo (default 1024)")
    ap.add_argument("--theta_warmup", type=int, default=8192, help="blocked theta's warmup sites (default 8192)")
    ap.add_argument("--pipeline_sites", type=int, default=13_000,
                    help="CpGs of the pipeline phase's chromosome (default 13000; batches of 6000 + 600)")
    ap.add_argument("--sg_pipeline_sites", type=int, default=5_000,
                    help="CpGs of the single-group pipeline phase's chromosome (default 5000)")
    ap.add_argument("--marginal_sites", type=int, default=2_000,
                    help="infer --marginal's segment size (default 2000)")
    ap.add_argument("--marginal_buffer", type=int, default=200, help="infer --marginal's halo size (default 200)")
    args = ap.parse_args(argv)
    if args.sites + args.buffer > args.chrom_sites:
        ap.error("the infer segment and halo must fit in the chromosome")
    if args.marginal_sites > args.sites:
        ap.error("the marginal segment must lie inside phase 7's segment")
    if args.sites + args.buffer <= args.stream_block:
        ap.error("the infer window must be longer than one streamed block")

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

    max_err, times = kernel_phase(device)
    onsets = hazard_phase(device)

    root = tempfile.mkdtemp(prefix="hygeia_smoke_")
    try:
        t0 = time.perf_counter()
        data_dir, sg_dir, dmr, regime = make_dataset(root, args.chrom_sites)
        print(f"dataset: {args.chrom_sites} CpGs, {int(dmr.sum())} sites in planted DMRs, "
              f"written in {time.perf_counter() - t0:.1f} s")
        sg_stats, sg_launches = single_group_phase(device, root, regime)
        stats, launches = slice_phase(device, root, data_dir, sg_dir, dmr, args.sites, args.buffer)
        st_stats, st_launches = streamed_phase(device, root, data_dir, sg_dir, args.sites, args.buffer, stats,
                                               args.stream_block)
        ch_stats, ch_launches = chromosome_phase(device, root, args.chrom2_sites)
        rb_stats, rb_launches = robust_phase(device, root, data_dir, sg_dir, dmr, args.robust_sites,
                                             args.robust_buffer)
        bl_stats, bl_launches = blocked_phase(device, root, regime, args.theta_block, args.theta_halo,
                                              args.theta_warmup)
        pl_stats, pl_launches = pipeline_phase(device, root, args.pipeline_sites)
        sgp_stats, sgp_launches = sg_pipeline_phase(device, root, args.sg_pipeline_sites)
        mg_stats, mg_launches = marginal_phase(device, root, data_dir, sg_dir, dmr, args.marginal_sites,
                                               args.marginal_buffer, os.path.join(root, "results", "chrom_1_0"),
                                               stats)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    sg = times["single_group"]
    shapes = {
        "single_group": f"U=1 N={SG_N} M={SG_N - R} (single-group engine)",
        "two_group": "U=1 N=2400 M=50 (one seed per infer call)",
        "two_group_u32": "U=32 N=2400 M=50",
        "two_group_m150": "U=1 N=7200 M=150",
        "single_group_u48": f"U=48 N={SG_N} M={SG_N - R} (blocked theta's units)",
    }
    print(json.dumps({"kernels": [{
        "name": "optimal_resampling",
        "route": "cuda",
        "source": "hygeia_tpu_torch/csrc/optimal_resampling.cu",
        "replaces": "hygeia_tpu/ops/pallas_resampling.py:50",
        "launches": (sg_launches + launches + st_launches + ch_launches + rb_launches + bl_launches + pl_launches
                     + sgp_launches + mg_launches),
        "launches_single_group": sg_launches,
        "launches_two_group": launches,
        "launches_streamed": st_launches,
        "launches_chromosome": ch_launches,
        "launches_robust": rb_launches,
        "launches_blocked": bl_launches,
        "launches_pipeline": pl_launches,
        "launches_single_group_pipeline": sgp_launches,
        "launches_marginal": mg_launches,
        # This run's counts per site, per path: over the resampling sites
        # (single group, two group), over the window's sites (streamed) and
        # over the sites of the chunks' windows (chromosome: one launch
        # serves every unit of a chunk).
        "launches_per_site": {"single_group": sg_stats["launches_per_site"],
                              "two_group": stats["launches_per_site"],
                              "streamed": st_stats["launches_per_site"],
                              "chromosome": ch_stats["launches_per_site"],
                              "robust": rb_stats["launches_per_site"],
                              "blocked": bl_stats["launches_per_site"],
                              "pipeline": pl_stats["launches_per_site"],
                              "single_group_pipeline": sgp_stats["launches_per_site"],
                              "marginal": mg_stats["launches_per_site"]},
        "max_abs_err": max_err,
        # The top-level times are the single-group engine's shape.
        "shape": shapes["single_group"],
        "ms": sg["ms"],
        "plain_ms": sg["plain_ms"],
        "bound_ms": sg["bound_ms"],
        "bound_by": sg["bound_by"],
        "library_ms": sg["library_ms"],
        "library": "torch.topk(lw, M + 1): the first stage alone; no single PyTorch call computes the resampler",
        "device_ms": sg["device_ms"],
        "enqueue_us": sg["enqueue_us"],
        "bytes": sg["bytes"],
        **times["floor"],
        "by_shape": {k: {"shape": shapes[k], **times[k]} for k in shapes},
    }], "card": card, "hazard_onsets": onsets, "single_group": sg_stats, "slice": stats,
        "streamed": st_stats, "chromosome": ch_stats, "robust": rb_stats, "blocked": bl_stats,
        "pipeline": pl_stats, "single_group_pipeline": sgp_stats, "marginal": mg_stats}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
