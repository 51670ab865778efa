#!/usr/bin/env python3
"""Smoke test of the PyTorch port (hygeia_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py                                       # the full check
    python3 chip_smoke.py --chrom_sites 3300 --sites 3000 --buffer 300 --stream_block 512 \
        --chrom2_sites 3000 --robust_sites 1200 --robust_buffer 120 --theta_block 1024 \
        --theta_halo 128 --theta_warmup 1024 --pipeline_sites 2600 --sg_pipeline_sites 1500 \
        --marginal_sites 1500 --marginal_buffer 150 --simulate_data_sites 1000 \
        --trace_sites 100 --trace_buffer 10 --mesh_sites 2000 --mesh_segment 500 --mesh_buffer 50 \
        --world2_sites 2400 --world2_segment 600 --world2_buffer 60 \
        --mesh_run_batch 700 --mesh_run_buffer 70 --graph_sites 1000 --graph_buffer 100 \
        --graph_stream_block 512 --graph_sg_sites 1000   # a quick look

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
4b. the off-path numerics on the card against the CPU: every function of
   the discrete-normal family at float64 within rtol 1e-12 over integers
   from tail to tail, and both conditional resamplers equal given the same
   uniforms (N = 40 at U = 256, N = 2,400 and M = 50 at U = 64);
5. a seeded reference-format chromosome of 105,000 CpGs is written to a
   temporary directory: 2 control + 2 case samples for ``infer`` and the
   two control samples as headed CSVs for the single-group engine, which
   reads all of it (40,000 while the site loops ran eagerly, PRs 5-8);
6. ``hygeia_tpu_torch.cli estimate_parameters_and_regimes`` on the control
   samples (N=250, M_cap=244, S_cap=128, D=36, both estimates on, f32),
   with checks on its output files, logZ, the theta trace, the kernel's
   launch count and the planted high and low methylation stretches; its
   theta file is the one the next phase reads;
7. ``hygeia_tpu_torch.cli infer`` on the estimated theta, batch 0 of the
   chromosome (the production segment, 100,000 + halo 5,000, M=50 -> N=2400,
   B=25, f32; cut to 10,000 + 1,000 while the site loops ran eagerly, PRs
   4-8), with checks on every
   output file, logZ, the degenerate-step count, the kernel's launch count
   and the planted differentially methylated windows;
8. ``infer --streaming_blocks 2048`` (runner.infer_segment, as the CLI
   calls it, with its per-block timings; ``--stream_block``) on the same
   window and seed: 52 blocks (51 x 2,048 + 552). Every npz array equal to phase 7's bit for
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
   5's 105,000 control CpGs at the CLI's defaults (N=250, M_cap=244, both
   estimates on, f32), block 8,192 + halo 1,024 and a warmup of 8,192
   sites (cut from the production 49,152 / 4,096 / 65,536 for time): 13
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
   second invocation runs no stage again; the run mirrors its tree to
   ``--bucket_dir file://<root>/bucket``, and after the output tree is
   deleted a third invocation restores it from the bucket (a
   BUCKET_RESTORE row), skips every stage, launches nothing and leaves the
   DMP files byte-equal to the first run's;
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
   chromosome, segment 20,000 + halo 1,000 (cut from the production
   100,000 + 5,000 for time; 2,000 + 200 while its loop ran eagerly),
   phase 6's theta,
   M=50 (N=2400), window 64, seeds 0 and 1 in one call: T - 1 launches,
   logZ finite, the spill counts printed, the split probability higher
   inside the planted DMRs than outside, the split and the regime
   probabilities within 0.1 and 0.07 (mean absolute) of phase 7's
   backward-simulation ones on the same sites, peak memory beside phase
   7's;
15. ``simulate_two_groups --run_inference`` through the CLI at the verb's
   defaults (T = 2,000, R = 6, M = 50 so N = 2,400, B = 25, seed 0): T - 1
   launches, logZ finite, no degenerate step, the JAX verb's 12 files and
   their shapes, control-regime recovery above 0.95 (the port's CPU runs
   read 0.981-0.994 over seeds 0-5); the simulation, filter and backward
   seconds apart;
16. ``simulate_data`` through the CLI (5,000 CpGs, 2 samples, the verb's
   defaults; ``--simulate_data_sites``), then
   ``estimate_parameters_and_regimes --estimate_regime_probabilities`` on
   its files at the simulation's theta: T - 1 launches, regime recovery
   above 0.95 (the CPU's 0.990-0.999 over seeds 0-2); then
   ``approximate_log_normalizing_constant`` with 8 replicates on the same
   counts: T - 1 launches serve all 8, every value finite, their spread
   printed;
17. ``infer --trace_dir`` through the CLI on batch 0 of phase 5's
   chromosome (segment 300 + halo 30, M = 50, one seed; ``--trace_sites``,
   ``--trace_buffer``), then the same call without it: npz arrays and logZ
   equal bit for bit; one trace file, its size; from the trace the CUDA
   kernels a site of the filter and of the backward pass (the
   ``infer.filter`` and ``infer.backward`` ranges), the CUDA graph replays
   in each and their kernels a replayed site (at most 10 a filter site),
   K1's and K2's kernels equal to the wrapper's count (which counts
   replays), the device's busy share of the
   traced window and its busy time against the untraced run's filter and
   backward seconds;
18. ``runner.infer_chromosome_meshed`` at world 1 on a fifth seeded
   chromosome of 8,000 CpGs with planted DMRs (``--mesh_sites``), mesh 4x2
   on the one card (8 units in one chunk), segment 2,000 + halo 200 (cut
   from 100,000 + 5,000), halo then exchange: K1's launches equal
   ``sharded.expected_launches`` ((seg + 2 buf) - 1 halo; (W - 1) + window
   exchange), logZ finite, no degenerate step, the split probability
   higher inside the DMRs; the seconds of tables, filter, backward and
   messages, the peak memory; the rho table's build at d_max = T + 1,
   65,537 and 2,300,001;
19. two ranks on the one card (torch.multiprocessing spawn, gloo), mesh
   4x2, halo and exchange through ``infer_chromosome_meshed`` on a sixth
   chromosome of 2,400 CpGs (make_dataset's planted DMRs need more than
   ~2,300), segment 600 + 60 (a cut depth): every npz array and logZ file
   equal bit for bit to a world-1 run in this process with chunks of a
   rank's units, each rank's launches one chunk's formula, the messages
   world 1's, one torch.distributed call each;
20. ``hygeia_tpu_torch.cli run --two_group --mesh 4x2 --boundary exchange``
   on phase 12's preprocessed chromosome with phase 12's theta stage copied
   in, batches of 3,300 + 330 (cut for time; ``--mesh_run_batch``): INFER[mesh],
   aggregate and DMPs run, the sequential run's file set per batch, one
   chunk's launches, weighted DMPs at least half in planted windows;
21. the site loops as replayed CUDA graphs (ops/site_graphs.py, the path
   every phase above takes) against the same loops run eagerly
   (``sites_per_graph=0``) in this call: ``infer_segment`` monolithic,
   streamed and ``--marginal`` (both seeds in one call; segment 3,000 +
   300, W = 1,024; ``--graph_sites``, ``--graph_buffer``,
   ``--graph_stream_block``) on phase 5's chromosome, phase 18's meshed
   halo run, ``estimate_parameters_and_regimes`` on the first 5,000
   control CpGs (``--graph_sg_sites``; its update sites replayed too):
   every npz array, logZ file and CSV equal bit for bit, the marginal
   filter's spill counts equal and T - 1 launches, K1's launches equal;
   ms/site of the loops and the peak memory of both; then both
   simulators' chains (simulate_two_groups's at its defaults, T = 2,000;
   simulate_data's model on 5,000 sites) graphed and eager on the same
   noise: the states equal bit for bit, ms/site of each.

Phase 3b (after 3): the probe kernel (``csrc/probe.cu``, 2*x + max(x) in
one block; replaces ``.round4/pallas_smoke.py:11``) through its wrapper on
arange(1024).reshape(8, 128) and a seeded random block, equal to
``2 * x + x.max()`` bit for bit, then timed. Phase 2 builds every
``csrc/*.cu``, one nvcc a source, all started together.

Phase 3c (after 3b): the filter-step kernel K2 (``csrc/filter_step.cu``)
through its wrapper against its plain version, ``_expand_and_weigh`` +
``_renormalise``, from the same carry (run_filter's on the card after a
few sites) and the same K1 outputs at M = 50, R = 6: the cell's shape
U = 2, N = 2,400 with (T, R) and with (U, T, R) emission rows, U = 32, the
no-resample site after a cold start, a unit whose ancestors are all dead;
children, parents, the -inf pattern and the degenerate flags equal, finite
weights and shifts within atol 2e-5, rtol 1e-6 (the shift's f32 sum is
taken in another order); then timed at U = 2 and U = 32: per call through
the wrapper and of the plain version (CUDA events), and each as a graph of
20 steps replayed behind a spin (the card's time a site step, as the
graphed filter loop replays it), beside the shape's bandwidth bound.

Phase 3d (after 3c): the backward-step kernel K3 (``csrc/backward_step.cu``)
through its wrapper against its plain version, ``_backward_logits`` with
the structured hazards + the Gumbel transform + argmax, over 255 sites of
a filter history on the card at M = 50, B = 25, R = 6, U = 2 and U = 32,
from the same carry and the same uniforms, the carry then following K3's
draws: the drawn states equal (a row that differed would have to be a
float32 tie of the plain version's largest noisy logits; the count is
reported), the trajectory row the new carry, the index counted down, one
launch a site; then timed at U = 2 and U = 32 as K2 is, beside the shape's
bandwidth bound, with the plain version's time (the draws, common to
both, left out).

Phase 3e (after 3d): the engine-step kernel K4 (``csrc/engine_step.cu``)
through the engine's K4 route against its plain version,
``_Engine._step_plain``, from the same state and K1 outputs at the theta
cell's widths (N = 250, S = 128, R = 6, D = 36, u = 3, both estimates,
updates every 200 sites) at U = 1 (one table) and U = 32 (a table a
unit), at a steady site, an update site and the last site of a 600-site
run stepped through K4 from the start: the particles, insertion slots,
finalisations and counts equal, every value within 2e-6 + 2e-5 s (s the
size it is summed from: its own |value|, or a row of psi's or a column of
phi's largest over the particles; f32 sums in another order), three
launches a site; then timed at U = 1 and U = 32: a site step through K4
and through the plain version eagerly (CUDA events), each and each stage
as a graph of 20 steps replayed, and whole steady sites (the draws, K1,
the step, the trace row, the index) 8 a graph through either route with
their graph nodes, beside the shape's bandwidth bound.

Every two-group phase resets the kernels' launch counts and checks that
K2 launched once a two-group filter site: as often as K1 (every filter
site is K1 then K2), less the theta stage's launches in the pipeline
phase; and that K3 launched once a backward site, counted from the calls
of the backward pass (T - 1 a call, and one more for a conditioned
terminal draw: ``count_backward_sites``). Every single-group phase checks
that neither launched. Every phase checks that K4 launched once a stage
(three with both estimates) at each single-group engine site at capacity
on the card, and counts the growth sites, which take the plain
composition, from the sites each engine call runs
(``count_engine_sites``): the theta, blocked, pipeline, single-group
pipeline, simulate_data and graphs phases run engines. The kernels line
gives K2's, K3's and K4's launches by path, and the growth sites.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Needs torch with CUDA and nvcc;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import gzip
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


# K2's and K3's launches by two-group run over the whole smoke, for the
# kernels line (``launches_since_reset``).
K2_LAUNCHES = {}
K3_LAUNCHES = {}
# The backward sites drawn since ``reset_launches`` (``count_backward_sites``).
BACKWARD_SITES = [0]
# K4's launches and the engine's growth sites on the card by run over the
# whole smoke, for the kernels line; and since ``reset_launches``, what the
# engine sites run owe K4 and the growth sites (``count_engine_sites``).
K4_LAUNCHES = {}
PLAIN_ENGINE_SITES = {}
ENGINE_SITES = {"k4_launches": 0, "plain": 0}


def count_backward_sites():
    """Wrap backward_simulation_conditioned wherever a path takes it from
    (backward_simulation calls it too), so that each call adds its
    backward sites, T - 1 and one more for a conditioned terminal draw, to
    BACKWARD_SITES: K3 must launch once for each."""
    from hygeia_tpu_torch.parallel import sharded
    from hygeia_tpu_torch.two_group import backward, streaming

    orig = backward.backward_simulation_conditioned
    if getattr(orig, "counts_sites", False):
        return

    def counted(params, log_weights, particles, terminal_state, use_terminal, **kw):
        BACKWARD_SITES[0] += log_weights.shape[1] - 1 + (use_terminal is not False)
        return orig(params, log_weights, particles, terminal_state, use_terminal, **kw)

    counted.counts_sites = True
    for mod in (backward, streaming, sharded):
        mod.backward_simulation_conditioned = counted


def count_engine_sites():
    """Wrap the single-group engine's ``_run_sites`` so that each call on
    the card adds what its sites owe K4 to ENGINE_SITES: a site t at
    capacity (min(R t, N) + R > N) launches it once a stage (WEIGHTS,
    SMOOTH with the regime pass, GRADIENT with the parameter estimate); a
    growth site takes the plain composition. Every engine on the card must
    be on K4's route."""
    from hygeia_tpu_torch.single_group import engine

    orig = engine._run_sites
    if getattr(orig, "counts_sites", False):
        return

    def counted(eng, loop, start, stop, draws):
        if eng.device.type == "cuda":
            check(eng.k4, f"single-group engine on {eng.device} (N={eng.N}, {eng.dtype}) is off K4's route")
            cfg = eng.config
            at_capacity = sum(min(eng.R * t, eng.N) + eng.R > eng.N for t in range(start, stop))
            ENGINE_SITES["k4_launches"] += at_capacity * (1 + cfg.estimate_regimes + cfg.estimate_parameters)
            ENGINE_SITES["plain"] += stop - start - at_capacity
        return orig(eng, loop, start, stop, draws)

    counted.counts_sites = True
    engine._run_sites = counted


def reset_launches():
    """The kernels' launch counts (K1, K2, K3, K4), the backward sites and
    the engine sites to 0, before a run."""
    from hygeia_tpu_torch.ops import cuda_backward_step, cuda_engine_step, cuda_filter_step, cuda_resampling

    cuda_resampling.KERNEL.launches = cuda_filter_step.KERNEL.launches = cuda_backward_step.KERNEL.launches = 0
    cuda_engine_step.KERNEL.launches = 0
    BACKWARD_SITES[0] = 0
    ENGINE_SITES.update(k4_launches=0, plain=0)


def launches_since_reset(path=None, two_group_sites=None, run=None):
    """K1's launches since ``reset_launches``. With ``path``, a run with a
    two-group stage: K2 must have launched once a two-group filter site,
    ``two_group_sites`` (default: as often as K1, for a run without a
    single-group stage), K3 once a backward site, and their counts are
    added to K2_LAUNCHES[path] and K3_LAUNCHES[path]. Without, a
    single-group run (``run`` names it): neither may have launched. Either
    way K4 must have launched what the engine sites run owe it
    (``count_engine_sites``); its launches and the growth sites are added
    to K4_LAUNCHES and PLAIN_ENGINE_SITES under the run's name."""
    from hygeia_tpu_torch.ops import cuda_backward_step, cuda_engine_step, cuda_filter_step, cuda_resampling

    k1, k2 = cuda_resampling.KERNEL.launches, cuda_filter_step.KERNEL.launches
    k3, sites = cuda_backward_step.KERNEL.launches, BACKWARD_SITES[0]
    k4 = cuda_engine_step.KERNEL.launches
    label = path or run or "single group"
    want = (k1 if two_group_sites is None else two_group_sites) if path else 0
    check(k2 == want, f"{label}: K2 launched {k2} times, K1 {k1}, expected {want}")
    check(k3 == sites and (path or sites == 0), f"{label}: K3 launched {k3} times for {sites} backward sites")
    check(k4 == ENGINE_SITES["k4_launches"],
          f"{label}: K4 launched {k4} times, its engine sites at capacity owe it {ENGINE_SITES['k4_launches']}")
    if path:
        K2_LAUNCHES[path] = K2_LAUNCHES.get(path, 0) + k2
        K3_LAUNCHES[path] = K3_LAUNCHES.get(path, 0) + k3
    if k4 or ENGINE_SITES["plain"]:
        K4_LAUNCHES[label] = K4_LAUNCHES.get(label, 0) + k4
        PLAIN_ENGINE_SITES[label] = PLAIN_ENGINE_SITES.get(label, 0) + ENGINE_SITES["plain"]
    return k1


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


def _events_ms(device, fn, n, behind_spin):
    """Milliseconds per call of fn by CUDA events over n calls. Behind a
    spin on the card the calls queue up first, so the events time the card
    and not the host that enqueues."""
    import torch

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

        device_ms = min(_events_ms(device, raw, 100, True) for _ in range(3))
        enqueue_us = min(host_us(lambda: optimal_resampling_cuda(lw, M, us, um)) for _ in range(3))
        library_ms = min(_events_ms(device, lambda: torch.topk(lw, M + 1), 100, True) for _ in range(3))
        n_bytes = units * (4 * N + 4 + 4 * M + 12 * M + 5)
        times = {}
        for name, fn in (("plain", plain.optimal_finite_state_resampling),
                         ("kernel", optimal_resampling_cuda),
                         ("kernel2", optimal_resampling_cuda),
                         ("plain2", plain.optimal_finite_state_resampling)):
            times[name] = _events_ms(device, lambda: fn(lw, M, us, um), 100, False)
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

    floor = {"launch_floor_ms": min(_events_ms(device, empty, 1000, True) for _ in range(3)),
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


def filter_step_phase(device, seed=0):
    """K2 against its plain version, ``_expand_and_weigh`` + ``_renormalise``,
    from the same carry and K1 outputs (phase 3c), then timed at U = 2 and
    U = 32. Returns (max |err| of the finite weights and shifts, {label:
    the shape's times})."""
    import numpy as np
    import torch
    from hygeia_tpu_torch.ops import cuda_filter_step as k2
    from hygeia_tpu_torch.ops.cuda_resampling import optimal_resampling
    from hygeia_tpu_torch.ops.emissions import emission_log_prob_table
    from hygeia_tpu_torch.two_group.filter import _expand_and_weigh, _renormalise, run_filter
    from hygeia_tpu_torch.two_group.model import make_params

    M, T = 50, 40
    N = M * (2 * R + R * R)
    params = make_params(mu=MU, sigma=SIGMA, p_softmax_control=np.zeros((R, R)),
                         omega_logit_control=np.full(R, 4.0), omega_case=0.8, kappa_control=np.full(R, 2.0),
                         kappa_case=np.full(R, 2.0), merge_log_prob=np.log(0.1), split_prob=0.01,
                         minimum_duration=3, d_max=T + 1, device=device)
    st = params.step_tables()
    rng = np.random.default_rng(seed)

    def tables(U):
        """Per-unit (U, T, R) control and case emission rows."""
        n = rng.poisson(20, size=(U, T, 2))
        tab = lambda p: torch.stack([emission_log_prob_table(rng.binomial(n[u], p), n[u], params.alpha,
                                                             params.beta) for u in range(U)])
        return tab(0.7), tab(0.3)

    def inputs(U, t, per_unit_rows):
        """The carry after t sites of run_filter on the card, uniforms and
        K1's outputs for site t."""
        E_c, E_k = tables(U)
        if not per_unit_rows:
            E_c, E_k = E_c[0], E_k[0]
        prev = run_filter(params, E_c[..., :t, :], E_k[..., :t, :], M, n_units=U,
                          generator=torch.Generator(device=device).manual_seed(seed + t), return_history=False)
        lw, parts = prev.log_weights.contiguous(), torch.stack(prev.particles, 1).contiguous()
        g = torch.Generator(device=device).manual_seed(seed + 1)
        u_sys, u_mult = torch.rand((U,), generator=g, device=device), torch.rand((U, M), generator=g, device=device)
        return E_c, E_k, lw, parts, optimal_resampling(lw, M, u_sys, u_mult)

    def outputs(U):
        return (torch.empty((U, N), device=device), torch.empty((U, 5, N), dtype=torch.int32, device=device),
                torch.zeros((U, T - 1), device=device), torch.zeros((U, T - 1), dtype=torch.bool, device=device),
                tuple(torch.zeros((U, T, N), dtype=dt, device=device) for dt in k2.HISTORY_DTYPES),
                torch.empty((U, M), dtype=torch.int64, device=device))

    def launcher(E_c, E_k, t, lw, parts, res, outs):
        idx = torch.tensor([t - 1, t], device=device)
        out_lw, out_parts, shifts, degen, hist, parents = outs
        return lambda: k2.filter_step_cuda(E_c, E_k, idx, lw, parts, res, M, st.rho_both, params.log_p_control,
                                           params.log_p_merged, params.min_duration, out_lw, out_parts, shifts,
                                           degen, hist, parents)

    def plain_step(E_c, E_k, t, lw, parts, res):
        new_lw, new_parts, parents = _expand_and_weigh(params, E_c[..., t, :], E_k[..., t, :], lw, parts, M, res,
                                                       return_parents=True)
        return (*_renormalise(new_lw), new_parts, parents)

    max_err = 0.0
    cases = {"cell": (2, 12, False), "per_unit_rows": (2, 12, True), "u32": (32, 12, False),
             "no_resample": (2, 1, False), "all_dead": (2, 12, False)}
    for label, (U, t, per_unit_rows) in cases.items():
        E_c, E_k, lw, parts, res = inputs(U, t, per_unit_rows)
        if label == "all_dead":  # unit 0: every ancestor dead, so every child
            parts[0, 2] = -1
        want_lw, want_shift, want_degen, want_parts, want_parents = plain_step(E_c, E_k, t, lw, parts, res)
        outs = outputs(U)
        before = k2.KERNEL.launches
        launcher(E_c, E_k, t, lw, parts, res, outs)()
        check(k2.KERNEL.launches == before + 1, f"K2 {label}: {k2.KERNEL.launches - before} launches for one call")
        got_lw, got_parts, shifts, degen, hist, parents = outs
        torch.cuda.synchronize(device)
        check(torch.equal(got_parts, want_parts), f"K2 {label}: children differ from the plain version's")
        check(torch.equal(parents, want_parents), f"K2 {label}: parents differ")
        check(torch.equal(degen[:, t - 1], want_degen), f"K2 {label}: degenerate flags differ")
        check(torch.equal(torch.isneginf(got_lw), torch.isneginf(want_lw))
              and torch.equal(torch.isfinite(got_lw), torch.isfinite(want_lw)), f"K2 {label}: -inf pattern differs")
        fin = torch.isfinite(want_lw)
        for name, g, w in (("weights", got_lw[fin], want_lw[fin]), ("shifts", shifts[:, t - 1], want_shift)):
            check(bool(torch.allclose(g, w, atol=2e-5, rtol=1e-6)), f"K2 {label}: {name} beyond atol 2e-5, rtol 1e-6")
            max_err = max(max_err, float((g.double() - w.double()).abs().max()))
        check(torch.equal(hist[0][:, t], got_lw), f"K2 {label}: history row {t} is not the new weights")
        live = torch.isfinite(lw).sum(-1)
        if label == "no_resample":
            check(bool((live <= M).all()), f"K2 {label}: {live.tolist()} live weights, not <= M")
        if label == "all_dead":
            check(degen[:, t - 1].tolist() == [True, False], f"K2 {label}: degenerate flags {degen[:, t - 1]}")
        else:
            check(not bool(degen.any()), f"K2 {label}: a degenerate site")
    print(f"K2 vs plain: the cell's shape U=2 N={N} M={M} R={R} with (T, R) and (U, T, R) rows, U=32, the "
          f"no-resample site, an all-dead unit: children, parents, -inf pattern and flags equal, max |err| "
          f"weights/shifts {max_err:.3g}")

    def graph_ms(fn, reps=20):
        """The card's time a call of fn: a graph of reps calls replayed
        behind a spin, CUDA events over 10 replays, best of 3."""
        fn()
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        return min(_events_ms(device, graph.replay, 10, True) for _ in range(3)) / reps

    def timed(U):
        """ms, plain_ms: per call through the wrapper and of the plain
        version, CUDA events over 100 and 20 calls, best of 3. device_ms,
        plain_device_ms: each as ``graph_ms`` gives it. bound_ms: the
        shape's bytes (the carry, K1's outputs and the emission rows read
        once; the carry, the history row, the parents, shift and flag
        written once; the hazard lookups left out, < 1%) over 3.35 TB/s."""
        E_c, E_k, lw, parts, res = inputs(U, 12, False)
        k2_call = launcher(E_c, E_k, 12, lw, parts, res, outputs(U))
        plain_call = lambda: plain_step(E_c, E_k, 12, lw, parts, res)
        n_bytes = U * (24 * N + 8 * M + 5 + 8 * R) + U * (24 * N + 15 * N + 8 * M + 5) + 4 * (R * R + 4)
        out = {
            "ms": min(_events_ms(device, k2_call, 100, False) for _ in range(3)),
            "plain_ms": min(_events_ms(device, plain_call, 20, False) for _ in range(3)),
            "device_ms": graph_ms(k2_call), "plain_device_ms": graph_ms(plain_call),
            "bytes": n_bytes, "bound_ms": 1e3 * n_bytes / 3.35e12, "bound_by": "bytes",
        }
        print(f"K2 at U={U} N={N} M={M}: per call through the wrapper {out['ms']:.4f} ms (plain "
              f"{out['plain_ms']:.4f} ms; CUDA events, best of 3); on the card, replayed in a graph, "
              f"{1e3 * out['device_ms']:.2f} us a site step (plain {1e3 * out['plain_device_ms']:.2f} us); bound "
              f"{1e6 * out['bound_ms']:.1f} ns ({n_bytes} bytes, by {out['bound_by']})")
        return out

    return max_err, {"two_group_cell": timed(2), "two_group_u32": timed(32)}


def backward_step_phase(device, seed=0):
    """K3 against its plain version, ``_backward_logits(history_layout=True)``
    + the Gumbel transform + argmax, site after site of a filter history
    from the same carry and uniforms (phase 3d), then timed at U = 2 and
    U = 32. Returns ({label: rows, rows drawn differently}, {label: the
    shape's times})."""
    import numpy as np
    import torch
    from hygeia_tpu_torch.ops import cuda_backward_step as k3
    from hygeia_tpu_torch.ops.emissions import emission_log_prob_table
    from hygeia_tpu_torch.two_group import backward as bw
    from hygeia_tpu_torch.two_group.filter import run_filter
    from hygeia_tpu_torch.two_group.model import State, make_params

    M, B, T = 50, 25, 256
    N = M * (2 * R + R * R)
    params = make_params(mu=MU, sigma=SIGMA, p_softmax_control=np.zeros((R, R)),
                         omega_logit_control=np.full(R, 4.0), omega_case=0.8, kappa_control=np.full(R, 2.0),
                         kappa_case=np.full(R, 2.0), merge_log_prob=np.log(0.1), split_prob=0.01,
                         minimum_duration=3, d_max=T + 1, device=device)
    st = params.step_tables()
    rng = np.random.default_rng(seed)

    def history(U):
        """run_filter's history on the card over per-unit tables, the
        uniforms' generator and a terminal carry drawn from the last
        weights."""
        n = rng.poisson(20, size=(U, T, 2))
        tab = lambda p: torch.stack([emission_log_prob_table(rng.binomial(n[u], p), n[u], params.alpha,
                                                             params.beta) for u in range(U)])
        res = run_filter(params, tab(0.7), tab(0.3), M, n_units=U,
                         generator=torch.Generator(device=device).manual_seed(seed + U))
        g = torch.Generator(device=device).manual_seed(seed + 1)
        lw, parts = res.log_weights, res.particles
        noise = bw._noise(torch.rand((U, B, N), generator=g, device=device))
        sel = bw._categorical_rows(lw[:, T - 1, None, :], noise)
        nxt = torch.stack([f[:, T - 1].gather(1, sel).to(torch.int32) for f in parts], dim=-1)
        return lw, parts, g, nxt

    def launch(idx, lw, parts, u, nxt, traj):
        k3.backward_step_cuda(idx, (lw, *parts), u, nxt, traj, st.rho_both, params.log_p_control,
                              params.log_p_merged, params.min_duration)

    checks = {}
    for label, U in (("cell", 2), ("u32", 32)):
        lw, parts, g, nxt = history(U)
        u = torch.empty((U, B, N), device=device)
        traj = torch.zeros((U, T, B, 5), dtype=torch.int32, device=device)
        idx = torch.tensor([T - 2, 0], device=device)
        ties = 0
        for t in range(T - 2, -1, -1):
            torch.rand(u.shape, generator=g, out=u)
            cur = State(*(f[:, t] for f in parts))
            v = bw._noise(u) + bw._backward_logits(params, cur, State(*nxt.unbind(-1)), lw[:, t],
                                                   history_layout=True)
            want = torch.stack([f.gather(1, v.argmax(-1)).to(torch.int32) for f in cur], dim=-1)
            got = nxt.clone()
            before = k3.KERNEL.launches
            launch(idx, lw, parts, u, got, traj)
            check(k3.KERNEL.launches == before + 1, f"K3 {label}: {k3.KERNEL.launches - before} launches a call")
            check(idx.tolist() == [t - 1, 0], f"K3 {label}: index {idx.tolist()} after site {t}")
            check(torch.equal(traj[:, t], got), f"K3 {label}: trajectory row {t} is not the new carry")
            differ = (got != want).any(-1)
            if bool(differ.any()):  # only a float32 tie of the plain version's largest noisy logits may differ
                state = torch.stack([f.to(torch.int32) for f in cur], dim=-1)
                mine = (state[:, None] == got[:, :, None]).all(-1)
                best = torch.where(mine, v, float("-inf")).amax(-1)[differ].double()
                top = v.amax(-1)[differ].double()
                check(bool(((top - best).abs() <= 4 * torch.finfo(torch.float32).eps * top.abs()).all()),
                      f"K3 {label}: site {t} draws a state the plain version's logits do not tie")
                ties += int(differ.sum())
            nxt = got
        checks[label] = {"rows": (T - 1) * U * B, "rows_drawn_differently": ties}
        check(ties <= 1e-3 * (T - 1) * U * B, f"K3 {label}: {ties} rows drawn differently")
    print(f"K3 vs plain: {T - 1} sites of a filter history at M={M} N={N} B={B} R={R}, U=2 and U=32, from the "
          f"same carry and uniforms: rows drawn differently (float32 ties) "
          f"{ {k: v['rows_drawn_differently'] for k, v in checks.items()} } of "
          f"{ {k: v['rows'] for k, v in checks.items()} }; one launch a site; the index counted down")

    def timed(U):
        """ms, plain_ms: per call through the wrapper and of the plain
        version (_plain_site from the uniforms: the noise, logits, argmax
        and writes), CUDA events over 100 and 20 calls, best of 3.
        device_ms, plain_device_ms: each as a graph of 20 calls replayed
        10 times behind a spin, best of 3. The draws (torch.rand), common
        to both, are left out. bound_ms: the shape's bytes (the history row
        and the uniforms read once, the carry read and written, the
        trajectory row written; the hazard lookups left out, < 1%) over
        3.35 TB/s. Every series restarts the index at T - 2."""
        lw, parts, g, nxt = history(U)
        u = torch.rand((U, B, N), generator=g, device=device)
        traj = torch.zeros((U, T, B, 5), dtype=torch.int32, device=device)
        idx = torch.tensor([T - 2, 0], device=device)
        k3_call = lambda: launch(idx, lw, parts, u, nxt, traj)
        plain_call = lambda: bw._plain_site(params, lw, parts, idx[:1], nxt, traj, bw._noise(u))

        def events_ms(fn, n):
            idx[0] = T - 2
            return _events_ms(device, fn, n, False)

        def graph_ms(fn, reps=20, replays=10):
            idx[0] = T - 2
            fn()
            torch.cuda.synchronize(device)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(reps):
                    fn()
            best = math.inf
            for _ in range(3):
                idx[0] = T - 2
                torch.cuda.synchronize(device)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(20_000_000)
                start.record()
                for _ in range(replays):
                    graph.replay()
                end.record()
                torch.cuda.synchronize(device)
                best = min(best, start.elapsed_time(end) / (replays * reps))
            return best

        n_bytes = U * (15 * N + 4 * B * N + 3 * 20 * B) + 4 * (R * R + 4 + 2 * R)
        out = {
            "ms": min(events_ms(k3_call, 100) for _ in range(3)),
            "plain_ms": min(events_ms(plain_call, 20) for _ in range(3)),
            "device_ms": graph_ms(k3_call), "plain_device_ms": graph_ms(plain_call),
            "bytes": n_bytes, "bound_ms": 1e3 * n_bytes / 3.35e12, "bound_by": "bytes",
        }
        print(f"K3 at U={U} B={B} N={N}: per call through the wrapper {out['ms']:.4f} ms (plain "
              f"{out['plain_ms']:.4f} ms; CUDA events, best of 3); on the card, replayed in a graph, "
              f"{1e3 * out['device_ms']:.2f} us a site step (plain {1e3 * out['plain_device_ms']:.2f} us); bound "
              f"{1e6 * out['bound_ms']:.1f} ns ({n_bytes} bytes, by {out['bound_by']})")
        return out

    return checks, {"two_group_cell": timed(2), "two_group_u32": timed(32)}


def _k4_engine(U, T, device, seed):
    """An _Engine on the card at the theta cell's widths (N = 250, S = 128,
    R = 6, D = 36, u = 3, both estimates, updates every 200 sites), one
    emission table a unit of synthetic counts of depth ~20."""
    import numpy as np
    import torch
    from hygeia_tpu_torch.ops.emissions import emission_log_prob_table
    from hygeia_tpu_torch.single_group.engine import EngineConfig, _Engine
    from hygeia_tpu_torch.single_group.model import make_model, parameters_to_theta

    model = make_model(list(MU), list(SIGMA), 3, np.full(R, 2.0), device=device)
    p = np.full((R, R), 1.0 / (R - 1))
    np.fill_diagonal(p, 0.0)
    theta = parameters_to_theta(p, [0.995, 0.975, 0.95, 0.925, 0.9, 0.9])
    rng = np.random.default_rng(seed + U)
    tables = []
    for _ in range(U):
        n = rng.poisson(20, size=(T, 2))
        y = rng.binomial(n, np.repeat(rng.uniform(0, 1, T // 50), 50)[:, None])
        tables.append(emission_log_prob_table(y, n, model.alpha, model.beta))
    cfg = EngineConfig(n_particles_max=SG_N, estimate_regimes=True, estimate_parameters=True, steps_per_update=200)
    return _Engine(model, theta, torch.stack(tables), cfg, U, torch.float32)


def _k4_gaps(got, want, t0, T):
    """{value: (max |got - want|, the largest |got - want| / (2e-6 + 2e-5 s))}
    over the finite entries of a site step's values through K4 (got) and
    the plain version (want), s the size each is summed from: its own
    |value|, or a row of psi's or a column of phi's largest over the
    particles (the score and the ADAM moments by phi's columns, theta and
    the tables by their rows). The non-finite entries must be equal."""
    import torch

    row = lambda x: x.abs().amax(-1, keepdim=True)
    phi_col = want["phi"].abs().amax(1)
    scales = {"psi": row(want["psi"]), "phi": want["phi"].abs().amax(1, keepdim=True), "score": phi_col,
              "grad_prev": phi_col, "adam_m": phi_col, "adam_v": phi_col**2, "theta": row(want["theta"]),
              "haz": row(want["haz"]), "trace": row(want["trace"][:, :t0 + 1])}
    gaps = {}
    for k in ("w", "shifts", "psi", "phi", "score", "theta", "grad_prev", "adam_m", "adam_v", "haz", "log_P", "P",
              "trace", "out"):
        a, b = got[k].double(), want[k].double()
        if k == "trace":  # rows past t0 are not written yet
            a, b = a[:, :t0 + 1], b[:, :t0 + 1]
        if k == "out":  # the sentinel row T is never read
            a, b = a[:, :T], b[:, :T]
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        check(torch.equal(fa, fb) and torch.equal(a[~fa].nan_to_num(0.0), b[~fb].nan_to_num(0.0)),
              f"K4: the non-finite entries of {k} differ from the plain version's")
        if not bool(fa.any()):
            gaps[k] = (0.0, 0.0)
            continue
        size = b.abs() if k not in scales else scales[k].double().expand_as(b)
        err = (a - b).abs()[fa]
        gaps[k] = (float(err.max()), float((err / (2e-6 + 2e-5 * size[fa])).max()))
    return gaps


def _graph_us(fn, calls, stream, generators=(), replays=30):
    """Microseconds a call of ``fn``: ``calls`` calls captured into one
    graph on ``stream`` (drawing from ``generators``), replayed ``replays``
    times behind CUDA events; the median, and the graph's nodes a call."""
    import statistics

    import torch
    from hygeia_tpu_torch.ops.site_graphs import captured_nodes

    with torch.cuda.stream(stream):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(calls):
                fn()
            nodes = captured_nodes(stream)
        graph.replay()
        torch.cuda.synchronize()
        out = []
        for _ in range(replays):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record(stream)
            graph.replay()
            b.record(stream)
            b.synchronize()
            out.append(a.elapsed_time(b) * 1e3 / calls)
    return statistics.median(out), nodes / calls


def engine_step_phase(device, seed=0):
    """K4 against its plain version, ``_Engine._step_plain``, from the same
    state and K1 outputs (phase 3e), then timed at U = 1 and U = 32.
    Returns ({label: {value: (max abs err, share of its tolerance)}},
    {label: the shape's times})."""
    import torch
    from hygeia_tpu_torch.ops import cuda_engine_step as k4
    from hygeia_tpu_torch.ops.cuda_resampling import optimal_resampling
    from hygeia_tpu_torch.single_group.engine import _site_uniforms

    T = 600
    snapshot = lambda eng: {**{k: v.clone() for k, v in eng.state.items() if torch.is_tensor(v)},
                            "haz": eng.haz.clone(), "log_P": eng.log_P.clone(), "P": eng.P.clone(),
                            "t_dev": eng.t_dev.clone()}

    def restore(eng, snap):
        for k, v in snap.items():
            (eng.state[k] if k in eng.state else getattr(eng, k)).copy_(v)

    checks = {}
    for U in (1, 32):
        eng = _k4_engine(U, T, device, seed)
        check(eng.k4, f"K4 U={U}: the engine on the card is off K4's route")
        g = torch.Generator(device=device).manual_seed(seed + 11)
        t = 1
        for t0, site in ((321, "steady"), (400, "update"), (T - 1, "last")):
            while t < t0:
                eng.step(t, *_site_uniforms(U, eng.M, g, device))
                t += 1
            draws = _site_uniforms(U, eng.M, g, device)
            before = snapshot(eng)
            launches = k4.KERNEL.launches
            eng.step(t0, *draws)
            check(k4.KERNEL.launches == launches + 3, f"K4 U={U} {site}: {k4.KERNEL.launches - launches} launches")
            got = snapshot(eng)
            restore(eng, before)
            eng.k4 = False
            eng.step(t0, *draws)
            eng.k4 = True
            want = snapshot(eng)
            check(k4.KERNEL.launches == launches + 3, f"K4 U={U} {site}: the plain version launched K4")
            for k in ("d", "r", "psi_time", "psi_valid", "spill", "adam_iter", "t_dev"):
                check(torch.equal(got[k], want[k]), f"K4 U={U} {site}: {k} differs from the plain version's")
            check(torch.equal(got["out_valid"][:, :T], want["out_valid"][:, :T]),
                  f"K4 U={U} {site}: the finalised rows differ from the plain version's")
            gaps = _k4_gaps(got, want, t0, T)
            worst = max(gaps, key=lambda k: gaps[k][1])
            check(gaps[worst][1] <= 1, f"K4 U={U} {site}: {worst} off the plain version by {gaps[worst][0]:.3g}, "
                                       f"{gaps[worst][1]:.2f} of its tolerance")
            checks[f"u{U}_{site}"] = gaps
            restore(eng, got)  # go on from K4's state
            t = t0 + 1
    print("K4 vs plain: U=1 and U=32 at N=250 S=128 R=6 D=36, a steady, an update and the last site: particles, "
          "slots, finalisations and counts equal; max |err| " + ", ".join(
              f"{label} {max(v[0] for v in gaps.values()):.3g} ({max(v[1] for v in gaps.values()):.2f} of "
              f"tolerance)" for label, gaps in checks.items()))

    def timed(U):
        """With one fixed draw of K1's outputs at site t0 = 301 of an
        engine stepped through K4 so far: device_ms and plain_device_ms, a
        site step through K4 (its three stages) and through the plain
        version, 20 steps a graph replayed (median of 30 replays);
        stages_device_ms, each stage alone so; ms and plain_ms, eagerly
        through the engine (CUDA events over 100 and 20 calls, best of 3);
        site_device_ms and site_plain_device_ms, whole steady sites (the
        draws, K1, the step, the trace row, the index) 8 a graph, with
        their graph nodes a site. Each restarts from the same state.
        bound_ms: the bytes K4 must move (psi, phi and the particles read
        and written once; K1's outputs and the table entries read once)
        over 3.35 TB/s."""
        t0 = 301
        eng = _k4_engine(U, 2000, device, seed)
        g = torch.Generator(device=device).manual_seed(seed + 1)
        for t in range(1, t0):
            eng.step(t, *_site_uniforms(U, eng.M, g, device))
        torch.cuda.synchronize(device)
        stream = torch.cuda.Stream(device)
        res = optimal_resampling(eng.state["w"], eng.M, *_site_uniforms(U, eng.M, g, device))
        snap = snapshot(eng)
        k4_step = lambda: eng._step_k4(t0, res)
        plain_step = lambda: eng._step_plain(t0, res, None)
        out = {}
        us, out["nodes"] = _graph_us(k4_step, 20, stream)
        out["device_ms"] = us / 1e3
        restore(eng, snap)
        out["stages_device_ms"] = {}
        for name, stage in (("weights", k4.WEIGHTS), ("smooth", k4.SMOOTH), ("gradient", k4.GRADIENT)):
            launch = lambda stage=stage: k4.engine_step_cuda(
                stage, eng.state, res, (eng.haz, eng.log_P, eng.P), eng.emissions, eng.k4_ws, eng.t_dev,
                min_duration=eng.model.u, epsilon=eng.config.epsilon)
            out["stages_device_ms"][name] = _graph_us(launch, 20, stream)[0] / 1e3
            restore(eng, snap)
        us, out["plain_nodes"] = _graph_us(plain_step, 20, stream)
        out["plain_device_ms"] = us / 1e3
        restore(eng, snap)
        out["ms"] = min(_events_ms(device, k4_step, 100, False) for _ in range(3))
        restore(eng, snap)
        out["plain_ms"] = min(_events_ms(device, plain_step, 20, False) for _ in range(3))
        t = t0 + 1  # a steady site; a graph of 8 replays sites t .. t + 7 from the same index
        for name, use in (("site", True), ("site_plain", False)):
            restore(eng, snap)
            eng.k4 = use
            base = eng.t_dev.clone()

            def sites():
                eng.t_dev.copy_(base)
                for _ in range(8):
                    eng.step(t, *_site_uniforms(U, eng.M, g, device))

            us, nodes = _graph_us(sites, 1, stream, (g,))
            out[f"{name}_device_ms"], out[f"{name}_nodes"] = us / 8e3, (nodes - 1) / 8
        eng.k4 = True
        N, S, D, M = eng.N, eng.S, eng.D, eng.M
        n_bytes = U * (2 * 4 * S * R * N + 2 * 4 * N * D + 2 * 20 * N + 12 * M + 12 * N)
        out.update(bytes=n_bytes, bound_ms=1e3 * n_bytes / 3.35e12, bound_by="bytes")
        print(f"K4 at U={U} N={N} S={S} R={R} D={D}: on the card, replayed in a graph, "
              f"{1e3 * out['device_ms']:.2f} us a site step (" + ", ".join(
                  f"{k} {1e3 * v:.2f}" for k, v in out["stages_device_ms"].items())
              + f" alone; plain {1e3 * out['plain_device_ms']:.2f} us, {out['plain_nodes']:.0f} nodes); eagerly "
              f"{out['ms']:.4f} ms (plain {out['plain_ms']:.4f}); a whole steady site "
              f"{1e3 * out['site_device_ms']:.2f} us in {out['site_nodes']:.1f} nodes (plain route "
              f"{1e3 * out['site_plain_device_ms']:.2f} us in {out['site_plain_nodes']:.1f}); bound "
              f"{1e6 * out['bound_ms']:.1f} ns ({n_bytes} bytes, by {out['bound_by']})")
        return out

    return checks, {"single_group_cell": timed(1), "single_group_u32": timed(32)}


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
    reset_launches()
    t0 = time.perf_counter()
    res = cli.main(argv)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    launches = launches_since_reset(run="theta")

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
    # K4 three times a site at capacity; the (N - R) // R growth sites plain.
    growth = (SG_N - R) // R
    check(K4_LAUNCHES["theta"] == 3 * (T - 1 - growth) and PLAIN_ENGINE_SITES["theta"] == growth,
          f"single group: K4 launched {K4_LAUNCHES['theta']} times, {PLAIN_ENGINE_SITES['theta']} growth sites, "
          f"for T={T} sites")
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
    reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    wall = time.perf_counter() - t0
    launches = launches_since_reset("two_group")
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
    from hygeia_tpu_torch.two_group.runner import infer_segment
    from hygeia_tpu_torch.two_group.streaming import block_bounds, launches_per_call

    T, N = segment_size + buffer_size, 50 * (2 * R + R * R)
    results = os.path.join(root, "results_streamed")
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    tim = {}
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        log_z = infer_segment(data_dir=data_dir, single_group_dir=sg_dir, results_dir=results, chrom="1",
                              device=device, batch=0, seed=seed, segment_size=segment_size,
                              buffer_size=buffer_size, streaming_blocks=block, timings=tim)[N]
    wall = time.perf_counter() - t0
    launches = launches_since_reset("streamed")
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
    from hygeia_tpu_torch.two_group.runner import infer_chromosome_streamed, segment_window
    from hygeia_tpu_torch.two_group.streaming import launches_per_call

    data_dir, sg_dir, dmr, _ = make_dataset(root, n_sites, seed=seed, chrom="2")
    shutil.copy(os.path.join(sg_dir, "theta_1.csv.gz"), os.path.join(sg_dir, "theta_2.csv.gz"))
    seg, buf, seeds, W = (CHROM2[k] for k in ("segment_size", "buffer_size", "seeds", "block"))
    results = os.path.join(root, "results_chrom")
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    tim = {}
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        log_z = infer_chromosome_streamed(data_dir=data_dir, single_group_dir=sg_dir, results_dir=results,
                                          chrom="2", device=device, seed=seeds, segment_size=seg,
                                          buffer_size=buf, streaming_blocks=W, timings=tim)
    wall = time.perf_counter() - t0
    launches = launches_since_reset("chromosome")
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
        reset_launches()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            log_z = cli.main(argv)[N]
        return log_z, time.perf_counter() - t0, launches_since_reset(name[len("results_"):]), out.getvalue()

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
    reset_launches()
    t0 = time.perf_counter()
    res = run_online_combined_inference_blocked(
        model, theta0.numpy(), E, cfg, block_size=block_size, halo=halo, warmup_sites=warmup_sites,
        generator=torch.Generator(device=device).manual_seed(seed), timings=tim)
    wall = time.perf_counter() - t0
    launches = launches_since_reset(run="blocked")
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
    from hygeia_tpu_torch.two_group.runner import segment_window
    from hygeia_tpu_torch.utils import io as hio

    cpg, controls, cases, dmr, pos0 = make_bed_dataset(os.path.join(root, "bed"), n_sites, chrom="3")
    out = os.path.join(root, "pipeline")
    bucket = os.path.join(root, "bucket")
    argv = ["run", "--two_group", "--output_dir", out, "--chroms", "3", "--cpg_file_path", cpg,
            "--batch_size", str(batch_size), "--buffer_size", str(buffer_size),
            "--num_of_inference_seeds", str(seeds), "--bucket_dir", f"file://{bucket}", "--device", str(device)]
    for flag, paths, prefix in (("control", controls, "c"), ("case", cases, "k")):
        for i, p in enumerate(paths):
            argv += [f"--{flag}_data_path", p, f"--{flag}_id_names", f"{prefix}{i}"]
    reset_launches()
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        cli.main(argv)
    wall = time.perf_counter() - t0
    N, B = 50 * (2 * R + R * R), 25
    n_batches = 1 + n_sites // batch_size
    windows = [len(segment_window(n_sites, b, batch_size, buffer_size)[0]) for b in range(n_batches)]
    check(all(w > 0 for w in windows), f"pipeline: an empty batch in {windows}")
    # K2 runs in INFER only, not in the theta stage.
    launches = launches_since_reset("pipeline", two_group_sites=sum(w - 1 for w in windows))
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
    reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(argv)
    wall2 = time.perf_counter() - t1
    resume_launches = launches_since_reset("pipeline_resume")
    # Its restore fetches the files of directories without a marker (the
    # INFER outputs; their markers are in the unit_* directories), as the
    # JAX package's mirror does: a BUCKET_RESTORE row, then only skips.
    rows2 = [r.split("\t") for r in open(os.path.join(out, "trace.tsv")).read().splitlines()[1:]]
    check(resume_launches == 0 and all(r[3] == "True" for r in rows2 if r[0] != "BUCKET_RESTORE"),
          f"pipeline: the resumed run ran stages again ({resume_launches} launches, {rows2})")
    check(wall2 < 0.1 * wall, f"pipeline: the resumed run took {wall2:.2f} s of the first's {wall:.2f} s")

    # A fresh machine: the output tree deleted, the run restored from the
    # bucket, every stage skipped, the DMP files the first run's.
    dmp_dir = os.path.join(out, "6_GET_DMPS", "3")
    dmps = {}
    for name in os.listdir(dmp_dir):
        with open(os.path.join(dmp_dir, name), "rb") as f:
            dmps[name] = f.read()
    shutil.rmtree(out)
    reset_launches()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(argv)
    wall3 = time.perf_counter() - t1
    bucket_launches = launches_since_reset("pipeline_bucket_resume")
    rows3 = [r.split("\t") for r in open(os.path.join(out, "trace.tsv")).read().splitlines()[1:]]
    check(bucket_launches == 0 and rows3[0][0] == "BUCKET_RESTORE" and all(r[3] == "True" for r in rows3[1:]),
          f"pipeline: the run restored from the bucket ran stages again ({bucket_launches} launches, {rows3})")
    for name, data in dmps.items():
        with open(os.path.join(dmp_dir, name), "rb") as f:
            check(f.read() == data, f"pipeline: {name} restored from the bucket differs from the first run's")
    stats = {"sites": n_sites, "batches": n_batches, "windows": windows, "seeds": seeds, "wall_s": wall,
             "stage_s": stage_s, "dmps_weighted_0.05": int(called.size), "precision": precision, "recall": recall,
             "resumed_wall_s": wall2, "bucket_restore": rows3[0][5], "bucket_resumed_wall_s": wall3,
             "launches_per_site": launches / (n_sites - 1 + sum(w - 1 for w in windows))}
    print(f"pipeline: {n_sites} CpGs from BED files, {n_batches} batches x {seeds} seeds: launches={launches}; "
          f"{wall:.2f} s, by stage {stage_s}; weighted_dmp_0.05: {called.size} positions, {precision:.3f} in planted "
          f"windows, recall {recall:.3f}; resumed run {wall2:.2f} s, no stage again; after deleting the tree, "
          f"restored from the bucket ({rows3[0][5]}) in {wall3:.2f} s, no stage again, launches={bucket_launches}, "
          f"DMP files equal")
    ctx = {"out": out, "cpg": cpg, "controls": controls, "cases": cases, "dmr": dmr, "pos0": pos0}
    return stats, launches, bucket_launches, ctx


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
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(argv)
    wall = time.perf_counter() - t0
    launches = launches_since_reset(run="single_group_pipeline")

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
    reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(argv)
    wall2 = time.perf_counter() - t1
    resume_launches = launches_since_reset(run="single_group_pipeline_resume")
    rows2 = [r.split("\t") for r in open(os.path.join(out, "trace.tsv")).read().splitlines()[1:]]
    check(resume_launches == 0 and rows2 and all(r[3] == "True" for r in rows2),
          f"single-group pipeline: the resumed run ran stages again ({resume_launches} launches, {rows2})")

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

    reset_launches()
    t3 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out2 = run_single_group(output_dir=os.path.join(root, "sg_pipeline_learn"), chroms=["4"], device=device,
                                samples=[(sid, os.path.join(out, f"1_PREPROCESS/{sid}/4")) for sid in samples],
                                mu=MU, sigma=SIGMA, u=3, n_steps_without_parameter_update=50,
                                learning_rate_factor=0.2)
    learn_s = time.perf_counter() - t3
    launches2 = launches_since_reset(run="single_group_pipeline_samples")
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


MARGINAL_SEEDS = (0, 1)


def marginal_phase(device, root, data_dir, sg_dir, dmr, segment_size, buffer_size, slice_dir, slice_stats,
                   seeds=MARGINAL_SEEDS, window=64):
    """infer --marginal (runner.infer_segment as the CLI calls it, its loop
    replayed as CUDA graphs) on batch 0 of phase 5's chromosome with phase
    6's theta, both seeds in one call (M=50, N=2400, window 64): T - 1
    launches (counted through the replays), logZ finite, the spill count,
    the split probability higher inside the planted DMRs than outside, the
    split and the regime probabilities within MARGINAL_SPLIT_BOUND and
    MARGINAL_REGIME_BOUND (mean absolute) of phase 7's backward-simulation
    ones on the same sites; peak memory beside phase 7's. Returns (stats,
    launches)."""
    import numpy as np
    import torch
    from hygeia_tpu_torch.two_group.runner import infer_segment

    T, N = segment_size + buffer_size, 50 * (2 * R + R * R)
    results = os.path.join(root, "results_marginal")
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        log_z = infer_segment(data_dir=data_dir, single_group_dir=sg_dir, results_dir=results, chrom="1",
                              device=device, batch=0, seed=list(seeds), segment_size=segment_size,
                              buffer_size=buffer_size, marginal=True, marginal_window=window)
    wall = time.perf_counter() - t0
    launches = launches_since_reset("marginal")
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


# ----------------------------------------------------- off-path numerics ----

def offpath_phase(device, seed=0):
    """The off-path numerics on the card against the CPU: every function of
    the discrete-normal family at float64 within rtol 1e-12 over integers
    from tail to tail (and the out-of-support guards); both conditional
    resamplers given the same uniforms, equal, at N = 40 (U = 256) and at
    the filter's N = 2400, M = 50 (U = 64). Returns its stats."""
    import numpy as np
    import torch
    from hygeia_tpu_torch.ops import discrete_normal as dn
    from hygeia_tpu_torch.ops import resampling as rs

    t0 = time.perf_counter()
    worst = 0.0
    n_funcs = 0
    for mean, sd in ((2.3, 1.7), (0.0, 1.0), (-3.0, 0.4), (10.0, 3.0)):
        xs = torch.arange(-60, 70, dtype=torch.float64)
        xs = xs[torch.abs((xs - mean) / sd) < 36]
        for name in sorted(n for n in dir(dn) if n.startswith(("log_", "grad_")) and n != "log_ndtr"):
            f = getattr(dn, name)
            if name == "log_diff_cdfs":
                args = (xs, xs - 3)
            elif "right" in name:
                args = (xs, 6)
            elif "left" in name:
                args = (xs, 1)
            elif "truncated" in name:
                args = (xs, 0, 8)
            else:
                args = (xs,)
            cpu = f(*args, mean, sd).numpy()
            card = f(*(a.to(device) if isinstance(a, torch.Tensor) else a for a in args), mean, sd).cpu().numpy()
            same = (card == cpu) | (np.isnan(card) & np.isnan(cpu))
            with np.errstate(invalid="ignore"):
                rel = np.abs(card - cpu)[~same] / np.abs(cpu[~same])
            r = float(rel.max()) if rel.size else 0.0
            check(r <= 1e-12, f"offpath: {name} on the card {r:.3g} (relative) from the CPU")
            worst = max(worst, r)
            n_funcs += 1
    rng = np.random.default_rng(seed)
    for U, n, m in ((256, 40, 40), (64, 2400, 50)):
        w = rng.dirichlet(np.full(n, 0.4), size=U)
        lw = torch.log(torch.from_numpy(w))
        a = torch.from_numpy(np.array([rng.choice(n, p=row) for row in w]))
        u, us = torch.from_numpy(rng.uniform(size=U)), torch.from_numpy(rng.uniform(size=U))
        um = torch.from_numpy(rng.uniform(size=(U, m)).astype(np.float32))
        for name, call in (
            ("conditional_systematic", lambda d: rs.conditional_systematic_resampling(
                lw.to(d), m, a.to(d), u.to(d), us.to(d))),
            ("conditional_multinomial", lambda d: rs.conditional_multinomial_resampling(
                lw.to(d), m, a.to(d), um.to(d))),
        ):
            cpu, card = call(torch.device("cpu")), call(device)
            check(torch.equal(cpu.parent_indices, card.parent_indices.cpu()) and torch.equal(cpu.b, card.b.cpu()),
                  f"offpath: {name} at N={n} differs on the card")
    stats = {"discrete_normal_functions": n_funcs, "discrete_normal_max_rel": worst, "wall_s": time.perf_counter() - t0}
    print(f"offpath: {n_funcs} discrete-normal evaluations at f64, card vs CPU max relative {worst:.3g} "
          f"(bound 1e-12); conditional systematic and multinomial resamplers equal at N=40 (U=256) and "
          f"N=2400 M=50 (U=64); {stats['wall_s']:.2f} s")
    return stats


# ------------------------------------------------------------ simulators ----

# Control-regime recovery of simulate_two_groups --run_inference at the
# verb's defaults: the port's CPU runs read 0.981-0.994 over seeds 0-5 (the
# JAX verb's 0.974-0.989 over seeds 0-2); the card draws another
# realisation.
SIMULATE_RECOVERY_BOUND = 0.95


def simulate_two_groups_phase(device, root, seed=0):
    """simulate_two_groups --run_inference through the CLI at the verb's
    defaults (T = 2,000, R = 6, M = 50 so N = 2,400, B = 25): T - 1
    launches, logZ finite, no degenerate step, the JAX verb's file set and
    shapes, control-regime recovery above SIMULATE_RECOVERY_BOUND; the
    simulation, filter and backward seconds apart. Returns (stats,
    launches)."""
    import numpy as np
    from hygeia_tpu_torch import cli

    out_dir = os.path.join(root, "simulate_two_groups")
    T, N, B = 2000, 50 * (2 * R + R * R), 25
    reset_launches()
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        res = cli.main(["simulate_two_groups", "--results_dir", out_dir, "--run_inference", "--seed", str(seed),
                        "--device", str(device)])
    wall = time.perf_counter() - t0
    launches = launches_since_reset("simulate_two_groups")
    print(text.getvalue().strip())
    check(launches == T - 1, f"simulate_two_groups: kernel launched {launches} times for T={T}")
    check(math.isfinite(res["log_z"]) and res["degenerate_steps"] == 0,
          f"simulate_two_groups: logZ {res['log_z']}, {res['degenerate_steps']} degenerate steps")
    expect = {
        "true_merged_states.npz": ((T,), np.int32), "true_control_states.npz": ((T, 2), np.int32),
        "true_case_states.npz": ((T, 2), np.int32),
        f"optimal_backward_particles_merged_state_{N}_{seed}.npz": ((T, B), np.int16),
        f"optimal_backward_particles_control_state_{N}_{seed}.npz": ((T, B, 2), np.int32),
        f"optimal_backward_particles_case_state_{N}_{seed}.npz": ((T, B, 2), np.int32),
        f"optimal_split_probs_{N}_{seed}.npz": ((T,), np.float32),
        f"optimal_regime_probs_{N}_{seed}.npz": ((T, 2 * R), np.float32),
    }
    for name, (shape, dtype) in expect.items():
        arr = np.load(os.path.join(out_dir, name))["arr_0"]
        check(arr.shape == shape and arr.dtype == dtype, f"simulate_two_groups: {name} {arr.shape} {arr.dtype}")
    for name in ("observations_control", "observations_case", "n_total_reads_control", "n_total_reads_case"):
        arr = np.loadtxt(os.path.join(out_dir, f"{name}.csv.gz"), delimiter=",")
        check(arr.shape == (T, 2), f"simulate_two_groups: {name}.csv.gz {arr.shape}")
    check(len(os.listdir(out_dir)) == 12, f"simulate_two_groups: files {sorted(os.listdir(out_dir))}")
    check(res["recovery"] > SIMULATE_RECOVERY_BOUND,
          f"simulate_two_groups: control-regime recovery {res['recovery']:.3f}, bound {SIMULATE_RECOVERY_BOUND}")
    stats = {"sites": T, "logZ": res["log_z"], "recovery": res["recovery"], "simulate_s": res["simulate_s"],
             "filter_s": res["filter_s"], "backward_s": res["backward_s"], "wall_s": wall,
             "split_fraction": float(np.mean(res["states"][:, 0] == 0)), "launches_per_site": launches / (T - 1)}
    print(f"simulate_two_groups: T={T} N={N} B={B} logZ={res['log_z']:.2f} launches={launches} recovery "
          f"{res['recovery']:.3f} (bound {SIMULATE_RECOVERY_BOUND}); simulation {res['simulate_s']:.2f} s, filter "
          f"{res['filter_s']:.2f} s ({1e3 * res['filter_s'] / T:.3f} ms/site), backward {res['backward_s']:.2f} s, "
          f"wall {wall:.2f} s")
    return stats, launches


# Regime recovery of estimate_parameters_and_regimes --estimate_regime_probabilities
# at the true theta on simulate_data's counts (5,000 CpGs, 2 samples, the
# verbs' defaults): the port's CPU runs of seeds 0-2 read 0.9988, 0.9908
# and 0.9904 (the float32 hazard trap of a learned theta does not arise at
# the true theta); the card draws another realisation.
SIMULATE_DATA_RECOVERY_BOUND = 0.95


def simulate_data_phase(device, root, n_sites, replicates=8, seed=0):
    """simulate_data through the CLI (n_sites CpGs, 2 samples, the verb's
    defaults), then estimate_parameters_and_regimes on its files with the
    regime pass at the simulation's theta (the verbs share their defaults):
    T - 1 launches, regime recovery against the simulated regimes printed
    and held to SIMULATE_DATA_RECOVERY_BOUND; then
    approximate_log_normalizing_constant with ``replicates`` replicates on
    the same counts: T - 1 launches serve all of them, every value finite,
    their spread printed. Returns (stats, launches of the regime pass,
    launches of the replicates)."""
    import numpy as np
    from hygeia_tpu_torch import cli
    from hygeia_tpu_torch.single_group.runner import approximate_log_normalizing_constant
    from hygeia_tpu_torch.utils import io as hio

    d = os.path.join(root, "simulate_data")
    f = {k: os.path.join(d, f"{k}.csv") for k in ("regimes", "meth", "pos", "total", "probs")}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["simulate_data", "--regimes_csv_file", f["regimes"], "--n_methylated_reads_csv_file", f["meth"],
                  "--genomic_positions_csv_file", f["pos"], "--n_total_reads_csv_file", f["total"],
                  "--n_cpg_sites", str(n_sites), "--rng_seed", str(seed), "--device", str(device)])
    sim_s = time.perf_counter() - t0
    regime = hio.read_headed_column(f["regimes"]).astype(np.int64)
    total, meth = hio.read_headed_matrix(f["total"]), hio.read_headed_matrix(f["meth"])
    check(regime.shape == (n_sites,) and total.shape == (2, n_sites) and meth.shape == (2, n_sites),
          f"simulate_data: shapes {regime.shape} {total.shape} {meth.shape}")
    check(bool(np.all((meth >= 0) & (meth <= total))), "simulate_data: counts outside [0, depth]")

    reset_launches()
    t0 = time.perf_counter()
    res = cli.main(["estimate_parameters_and_regimes", "--n_methylated_reads_csv_file", f["meth"],
                    "--n_total_reads_csv_file", f["total"], "--genomic_positions_csv_file", f["pos"],
                    "--estimate_regime_probabilities", "--regime_probabilities_csv_file", f["probs"],
                    "--progress_every", "0", "--device", str(device)])
    est_s = time.perf_counter() - t0
    est_launches = launches_since_reset(run="simulate_data")
    check(est_launches == n_sites - 1, f"simulate_data: the regime pass launched {est_launches} times")
    _cols, probs = hio.read_headed_table(f["probs"])
    recovery = float(np.mean(probs[:, 1:].argmax(1) == regime))
    check(math.isfinite(float(res.log_normalizing_constant[0])), "simulate_data: the regime pass's logZ")
    check(recovery > SIMULATE_DATA_RECOVERY_BOUND,
          f"simulate_data: regime recovery {recovery:.3f}, bound {SIMULATE_DATA_RECOVERY_BOUND}")

    reset_launches()
    t0 = time.perf_counter()
    log_z = approximate_log_normalizing_constant(n_replicates=replicates, n_methylated_reads=meth.T,
                                                 n_total_reads=total.T, device=device, rng_seed=seed)
    rep_s = time.perf_counter() - t0
    rep_launches = launches_since_reset(run="replicates")
    check(rep_launches == n_sites - 1, f"replicates: launched {rep_launches} times for {replicates} replicates")
    check(log_z.shape == (replicates,) and bool(np.all(np.isfinite(log_z))), f"replicates: logZ {log_z}")
    stats = {"sites": n_sites, "simulate_s": sim_s, "regime_pass_s": est_s, "recovery": recovery,
             "regime_pass_logZ": float(res.log_normalizing_constant[0]), "replicates": replicates,
             "replicates_s": rep_s, "replicate_logZ": [float(x) for x in log_z],
             "replicate_logZ_sd": float(np.std(log_z, ddof=1)),
             "regime_pass_ms_per_site": 1e3 * est_s / n_sites, "replicates_ms_per_site": 1e3 * rep_s / n_sites,
             "launches_per_site": est_launches / (n_sites - 1)}
    print(f"simulate_data: {n_sites} CpGs simulated in {sim_s:.2f} s; regime pass at the true theta: "
          f"launches={est_launches}, {est_s:.2f} s ({stats['regime_pass_ms_per_site']:.3f} ms/site), recovery "
          f"{recovery:.3f}; {replicates} replicates of logZ in one call: launches={rep_launches}, {rep_s:.2f} s "
          f"({stats['replicates_ms_per_site']:.3f} ms/site), mean {np.mean(log_z):.3f}, sd "
          f"{stats['replicate_logZ_sd']:.3g}, range {np.ptp(log_z):.3g}, {len(np.unique(log_z))} distinct")
    return stats, est_launches, rep_launches


# ---------------------------------------------------------------- trace ----

def _trace_shares(path):
    """Counts and shares from a torch.profiler Chrome trace: CUDA kernels
    launched inside the ``infer.filter`` and ``infer.backward`` ranges (by
    the correlation of each kernel with its launch call), the CUDA graph
    launches in each and the kernels those launched (a replayed graph's
    kernels carry its launch's correlation), K1's kernels, and the
    device's busy share of the traced window (the union of kernel, copy
    and set intervals over the span of all events)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    gpu = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    calls = [e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in calls}
    graph_calls = {e["args"]["correlation"] for e in calls if "GraphLaunch" in e["name"]}
    ranges = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("name") in ("infer.filter", "infer.backward")}
    in_range = {name: 0 for name in ranges}
    graph_kernels = {name: 0 for name in ranges}
    graph_launches = {name: sum(lo <= launch_ts[c] <= hi for c in graph_calls) for name, (lo, hi) in ranges.items()}
    for k in kernels:
        corr = k.get("args", {}).get("correlation")
        ts = launch_ts.get(corr)
        for name, (lo, hi) in ranges.items():
            if ts is not None and lo <= ts <= hi:
                in_range[name] += 1
                graph_kernels[name] += corr in graph_calls
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    busy, end = 0.0, lo
    for s, e in sorted((g["ts"], g["ts"] + g["dur"]) for g in gpu):
        if e > end:
            busy += e - max(s, end)
            end = e
    return {"events": len(events), "kernels": len(kernels),
            "k1_kernels": sum("optimal_resampling" in k["name"] for k in kernels),
            "k2_kernels": sum("filter_step" in k["name"] for k in kernels),
            "k3_kernels": sum("backward_step" in k["name"] for k in kernels),
            "kernels_in_range": in_range, "graph_launches_in_range": graph_launches,
            "graph_kernels_in_range": graph_kernels, "ranges_us": {k: v[1] - v[0] for k, v in ranges.items()},
            "window_us": hi - lo, "busy_us": busy, "busy_share": busy / (hi - lo) if hi > lo else 0.0}


def trace_phase(device, root, data_dir, sg_dir, segment_size, buffer_size, seed=0):
    """infer --trace_dir through the CLI on batch 0 of phase 5's chromosome
    (segment_size + buffer_size sites, M = 50, one seed), then the same call
    without it: every npz array and the logZ file equal bit for bit; one
    trace file written, its size; from it the CUDA kernels a site of the
    filter and of the backward pass, K1's kernels (checked equal to the
    wrapper's counter), the device's busy share of the traced window and
    its busy time against the untraced run's filter and backward seconds.
    Returns (stats, launches of the traced run)."""
    import numpy as np
    from hygeia_tpu_torch import cli

    T = segment_size + buffer_size
    trace_dir = os.path.join(root, "trace")
    outs = {}
    launches = walls = None
    for label, extra in (("traced", ["--trace_dir", trace_dir]), ("plain", [])):
        results = os.path.join(root, f"results_{label}")
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["infer", "--data_dir", data_dir, "--single_group_dir", sg_dir, "--results_dir", results,
                      "--chrom", "1", "--segment_size", str(segment_size), "--buffer_size", str(buffer_size),
                      "--batch", "0", "--seed", str(seed), "--device", str(device), *extra])
        outs[label] = (os.path.join(results, "chrom_1_0"), time.perf_counter() - t0,
                       launches_since_reset("trace" if label == "traced" else "trace_untraced"))
    (a_dir, wall_traced, launches), (b_dir, wall_plain, plain_launches) = outs["traced"], outs["plain"]
    check(launches == plain_launches == T - 1, f"trace: launches {launches} traced, {plain_launches} plain")
    names = sorted(n for n in os.listdir(a_dir) if n.endswith(".npz") or n.startswith("log_normalizing"))
    check(names == sorted(n for n in os.listdir(b_dir) if n.endswith(".npz") or n.startswith("log_normalizing")),
          "trace: other files with --trace_dir")
    for name in names:
        if name.endswith(".npz"):
            a, b = np.load(os.path.join(a_dir, name))["arr_0"], np.load(os.path.join(b_dir, name))["arr_0"]
            check(a.dtype == b.dtype and np.array_equal(a, b), f"trace: {name} differs with --trace_dir")
        else:
            with open(os.path.join(a_dir, name)) as fa, open(os.path.join(b_dir, name)) as fb:
                check(fa.read() == fb.read(), "trace: logZ differs with --trace_dir")
    traces = sorted(f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")) if os.path.isdir(
        trace_dir) else []
    check(len(traces) == 1, f"trace: {len(traces)} trace files written in {trace_dir}")
    path = os.path.join(trace_dir, traces[0])
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    sh = _trace_shares(path)
    parse_s = time.perf_counter() - t0
    check(sh["kernels"] > 0, "trace: no CUDA kernel in the trace")
    check(sh["k1_kernels"] == launches,
          f"trace: {sh['k1_kernels']} K1 kernels in the trace, the wrapper counted {launches} (CUPTI records "
          "what the ctypes launch of the kernel puts on the stream only if it sees the launch)")
    check(sh["k2_kernels"] == launches, f"trace: {sh['k2_kernels']} K2 kernels in the trace, K1's {launches}")
    check(sh["k3_kernels"] == T - 1, f"trace: {sh['k3_kernels']} K3 kernels in the trace, {T - 1} backward sites")
    per_site = {k: v / T for k, v in sh["kernels_in_range"].items()}
    # Each loop steps its first site eagerly and replays the other T - 2.
    check(set(sh["graph_launches_in_range"]) == {"infer.filter", "infer.backward"}
          and all(v > 0 for v in sh["graph_launches_in_range"].values()),
          f"trace: CUDA graph launches in the loops {sh['graph_launches_in_range']}")
    replays_per_site = {k: v / (T - 2) for k, v in sh["graph_launches_in_range"].items()}
    graph_kernels_per_site = {k: v / (T - 2) for k, v in sh["graph_kernels_in_range"].items()}
    # A filter site is two draws, K1, K2 and the index's advance; a backward
    # site the draw and K3.
    for loop in ("infer.filter", "infer.backward"):
        check(graph_kernels_per_site[loop] <= 10,
              f"trace: {graph_kernels_per_site[loop]:.2f} kernels a replayed site of {loop}, more than 10")
    # The profiler slows the host several times over, so the traced window's
    # busy share understates the untraced run's: set the device time the
    # trace holds against the untraced run's filter and backward seconds.
    loop_s = 0.0
    for name in (f"optimal_time_{seed}.txt", f"optimal_time_backward_{seed}.txt"):
        with open(os.path.join(b_dir, name)) as f:
            loop_s += float(next(iter(ast.literal_eval(f.read()).values())))
    busy_untraced = sh["busy_us"] / 1e6 / loop_s
    stats = {"sites": T, "trace_bytes": size, "trace_bytes_per_site": size / T, "parse_s": parse_s,
             "wall_traced_s": wall_traced, "wall_plain_s": wall_plain, "kernels_per_site": per_site,
             "graph_replays_per_site": replays_per_site, "graph_kernels_per_site": graph_kernels_per_site,
             "device_ms_per_site": sh["busy_us"] / 1e3 / T, "untraced_loops_s": loop_s,
             "busy_share_of_untraced_loops": busy_untraced, **sh}
    print(f"trace: T={T} one trace of {size} bytes ({size / T:.0f} a site, {sh['events']} events) parsed in "
          f"{parse_s:.2f} s; outputs equal to the untraced run's; CUDA kernels a site: "
          f"{ {k: round(v, 2) for k, v in per_site.items()} }; graph replays a replayed site "
          f"{ {k: round(v, 4) for k, v in replays_per_site.items()} }, their kernels a replayed site "
          f"{ {k: round(v, 2) for k, v in graph_kernels_per_site.items()} }; "
          f"K1 kernels in the trace {sh['k1_kernels']} = "
          f"wrapper {launches}; device busy {sh['busy_us'] / 1e3:.2f} ms of a {sh['window_us'] / 1e3:.2f} ms "
          f"window ({100 * sh['busy_share']:.1f}%), {stats['device_ms_per_site']:.3f} ms a site, "
          f"{100 * busy_untraced:.1f}% of the untraced run's filter and backward {loop_s:.3f} s; wall traced "
          f"{wall_traced:.2f} s, untraced {wall_plain:.2f} s")
    return stats, launches

# ----------------------------------------------------------------- probe ----

def probe_phase(device, seed=0):
    """The probe kernel (csrc/probe.cu, 2*x + max(x) in one block) through
    its wrapper on .round4/pallas_smoke.py's arange(1024).reshape(8, 128)
    and on a seeded random block: equal to 2 * x + x.max() bit for bit.
    Then timed: the card's time a launch (raw launches behind a spin, best
    of 3), per call through the wrapper beside the plain version (CUDA
    events, turns plain, kernel, kernel, plain), and its bound: 4 KiB read
    and 4 KiB written at 3.35 TB/s (3 operations an element at 67 TFLOP/s
    f32 take less). Returns (stats, launches of the checked calls)."""
    import numpy as np
    import torch
    from hygeia_tpu_torch.ops.probe import PROBE, probe, probe_cuda, probe_plain

    xs = {"arange": torch.arange(8 * 128, dtype=torch.float32, device=device).reshape(8, 128),
          "random": torch.from_numpy((np.random.default_rng(seed).standard_normal((8, 128)) * 10)
                                     .astype(np.float32)).to(device)}
    PROBE.launches = 0
    outs = {k: probe(x) for k, x in xs.items()}
    _sync(device)
    launches = PROBE.launches
    check(launches == len(xs), f"probe: {launches} launches for {len(xs)} calls")
    max_err = 0.0
    for k, x in xs.items():
        want = probe_plain(x)
        max_err = max(max_err, float((outs[k] - want).abs().max()))
        check(outs[k].dtype == want.dtype and torch.equal(outs[k], want),
              f"probe ({k}): {int((outs[k] != want).sum())} entries differ from 2 * x + x.max()")
    x = xs["random"]
    out = torch.empty_like(x)
    raw = (x.data_ptr(), out.data_ptr(), x.numel(), torch.cuda.current_stream(device).cuda_stream)

    def launch():
        check(PROBE.lib.hygeia_probe(*raw) == 0, "probe: raw launch refused")

    device_ms = min(_events_ms(device, launch, 1000, True) for _ in range(3))
    turns = {}
    for name, fn in (("plain", probe_plain), ("kernel", probe_cuda), ("kernel2", probe_cuda), ("plain2", probe_plain)):
        turns[name] = _events_ms(device, lambda: fn(x), 200, False)
    n_bytes = 2 * 4 * x.numel()
    stats = {"ms": min(turns["kernel"], turns["kernel2"]), "plain_ms": min(turns["plain"], turns["plain2"]),
             "device_ms": device_ms, "bytes": n_bytes, "bound_ms": 1e3 * n_bytes / 3.35e12,
             "ops_bound_ms": 1e3 * 3 * x.numel() / 67e12, "bound_by": "bytes", "max_abs_err": max_err}
    print(f"probe kernel: 2*x + max(x) on arange(1024).reshape(8, 128) and a random (8, 128) block equal to "
          f"2 * x + x.max() bit for bit; {1e3 * device_ms:.2f} us a launch on the card; per call "
          f"{stats['ms']:.4f} ms through the wrapper (plain {stats['plain_ms']:.4f} ms); bound "
          f"{1e6 * stats['bound_ms']:.2f} ns ({n_bytes} bytes)")
    return stats, launches


# ---------------------------------------------------------------- meshed ----

MESH_SHAPE = (4, 2)
MESH_SEEDS = (0, 1)
# Further depths of the rho build's timing (the meshed runner's d_max is
# T + 1: 2,300,001 for a 2.3M-CpG chromosome).
RHO_D_MAX = (65_537, 2_300_001)


def _mesh_split(results, chrom, n_sites, segment_size, seeds, N):
    """Per seed, the (T,) split probabilities of a meshed run's batches
    (their segment rows, in order), and each batch's logZ."""
    import numpy as np

    n_batches = 1 + n_sites // segment_size
    split = {}
    log_z = {}
    for s in seeds:
        split[s] = np.concatenate([
            np.load(os.path.join(results, f"chrom_{chrom}_{b}", f"optimal_split_probs_{N}_{s}.npz"))["arr_0"]
            for b in range(n_batches)])
        for b in range(n_batches):
            with open(os.path.join(results, f"chrom_{chrom}_{b}", f"log_normalizing_constants_optimal_{s}.txt")) as f:
                log_z[(b, s)] = ast.literal_eval(f.read())[N]
    return split, log_z


def meshed_phase(device, root, n_sites, segment_size, buffer_size, seed=7):
    """runner.infer_chromosome_meshed at world 1 on a fifth seeded
    chromosome "5" (planted DMRs, phase 6's theta), mesh 4x2 on the one card
    (8 units), halo then exchange: all 8 units in one chunk; K1 launched as
    sharded.expected_launches says; every logZ finite; no degenerate step;
    the split probability higher inside the DMRs than outside; the seconds
    of tables, filter, backward and messages and the peak memory. Then the
    rho table's build (d_max = T + 1, as the meshed runner builds it) timed
    at this T and at RHO_D_MAX. Returns (stats, {boundary: launches})."""
    import numpy as np
    import torch
    from hygeia_tpu_torch.parallel.sharded import MESSAGES, expected_launches
    from hygeia_tpu_torch.two_group.runner import _make_params, infer_chromosome_meshed
    from hygeia_tpu_torch.utils import io as hio

    data_dir, sg_dir, dmr, _ = make_dataset(root, n_sites, seed=seed, chrom="5")
    shutil.copy(os.path.join(sg_dir, "theta_1.csv.gz"), os.path.join(sg_dir, "theta_5.csv.gz"))
    N = 50 * (2 * R + R * R)
    n_blocks = -(-max(1, -(-n_sites // segment_size)) // MESH_SHAPE[0]) * MESH_SHAPE[0]
    bpd = n_blocks // MESH_SHAPE[0]
    stats, launches = {}, {}
    for boundary in ("halo", "exchange"):
        results = os.path.join(root, f"results_mesh_{boundary}")
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        reset_launches()
        tim = {}
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            infer_chromosome_meshed(data_dir=data_dir, single_group_dir=sg_dir, results_dir=results, chrom="5",
                                    mesh_shape=MESH_SHAPE, device=device, boundary=boundary, seed=MESH_SEEDS,
                                    segment_size=segment_size, buffer_size=buffer_size, timings=tim)
        wall = time.perf_counter() - t0
        launches[boundary] = launches_since_reset(f"meshed_{boundary}")
        t = tim[N]
        units = (n_blocks if boundary == "halo" else MESH_SHAPE[0]) * len(MESH_SEEDS)
        check(t["chunks"] == [units], f"meshed {boundary}: chunks {t['chunks']}, expected all {units} units in one")
        want = expected_launches(boundary, segment_size, buffer_size, bpd, 1)
        check(launches[boundary] == want, f"meshed {boundary}: K1 launched {launches[boundary]} times, the formula "
                                          f"gives {want}")
        check(int(t["degenerate"].sum()) == 0, f"meshed {boundary}: {int(t['degenerate'].sum())} degenerate steps")
        split, log_z = _mesh_split(results, "5", n_sites, segment_size, MESH_SEEDS, N)
        check(all(math.isfinite(v) for v in log_z.values()), f"meshed {boundary}: logZ not finite")
        sp = np.mean([split[s] for s in MESH_SEEDS], axis=0)
        check(sp.shape == (n_sites,), f"meshed {boundary}: split probabilities of {sp.shape} sites")
        in_dmr, out_dmr = float(sp[dmr].mean()), float(sp[~dmr].mean())
        check(in_dmr > out_dmr, f"meshed {boundary}: split probability in DMRs {in_dmr:.3f} <= outside {out_dmr:.3f}")
        stats[boundary] = {
            "sites": n_sites, "units": units, "wall_s": wall,
            **{k: t[k] for k in ("tables_s", "filter_s", "backward_s", "messages_s")},
            "messages": MESSAGES.rounds, "distributed_calls": MESSAGES.calls,
            "split_in_dmr": in_dmr, "split_outside": out_dmr,
            "logZ": {f"{b},{s}": v for (b, s), v in log_z.items()},
            "max_memory_allocated_bytes": (torch.cuda.max_memory_allocated(device)
                                           if device.type == "cuda" else None),
            "launches": launches[boundary],
        }
        print(f"meshed {boundary}: {n_sites} CpGs, mesh {MESH_SHAPE[0]}x{MESH_SHAPE[1]}, {units} units in one chunk, "
              f"launches={launches[boundary]} (formula {want}); tables {t['tables_s']:.2f} s, filter "
              f"{t['filter_s']:.2f} s, backward {t['backward_s']:.2f} s, messages {t['messages_s']:.4f} s "
              f"({MESSAGES.rounds} messages), wall {wall:.2f} s; split prob in DMRs {in_dmr:.3f} vs outside "
              f"{out_dmr:.3f}; max_memory_allocated {stats[boundary]['max_memory_allocated_bytes']}")
    theta = hio.read_theta(os.path.join(sg_dir, "theta_5.csv.gz"))
    p_softmax, omega_logit = hio.theta_file_to_p_softmax(theta, R)
    rho_s = {}
    for d_max in (n_sites + 1, *RHO_D_MAX):
        _sync(device)
        t0 = time.perf_counter()
        _make_params(np.asarray(MU), SIGMA, p_softmax, omega_logit, 0.8, math.log(0.1), 0.01, 3, d_max, device)
        _sync(device)
        rho_s[d_max] = time.perf_counter() - t0
    stats["rho_build_s"] = rho_s
    print(f"meshed: the params' rho tables (d_max = T + 1) built in "
          + ", ".join(f"{v:.3f} s at d_max {k}" for k, v in rho_s.items()))
    return stats, launches


# ----------------------------------------------------- graphs vs eager ----

def _same_files(a_dir, b_dir, what):
    """Every .npz array, text and CSV file of a_dir equal to b_dir's (the
    timing files, which differ by nature, left out; gzip files by their
    contents)."""
    import numpy as np

    names = sorted(n for n in os.listdir(a_dir) if "time" not in n)
    check(names == sorted(n for n in os.listdir(b_dir) if "time" not in n), f"{what}: other files")
    for name in names:
        pa, pb = os.path.join(a_dir, name), os.path.join(b_dir, name)
        if name.endswith(".npz"):
            a, b = np.load(pa)["arr_0"], np.load(pb)["arr_0"]
            check(a.dtype == b.dtype and np.array_equal(a, b), f"{what}: {name} differs graphed and eager")
        else:  # a gzip member's header holds its time: compare what it holds
            read = gzip.open if name.endswith(".gz") else open
            with read(pa, "rb") as fa, read(pb, "rb") as fb:
                check(fa.read() == fb.read(), f"{what}: {name} differs graphed and eager")
    return len(names)


@contextlib.contextmanager
def _loop_timer(device):
    """While open, every ``SiteLoop.run`` call, every capture of a new
    graph and every ``engine._run_sites`` call (the single-group engine's
    whole site loop) timed between two device syncs. Yields the record:
    "runs" {kind: [seconds of each run call]}, "sites" {kind: sites},
    "capture_s" (the captures' seconds, which the run calls include),
    "engine_loop" [seconds, sites]. Each sync drains the queue once a run
    call or a capture."""
    from hygeia_tpu_torch.ops.site_graphs import SiteLoop
    from hygeia_tpu_torch.single_group import engine as em

    rec = {"runs": {}, "sites": {}, "capture_s": 0.0, "engine_loop": [0.0, 0]}
    run, graph, run_sites = SiteLoop.run, SiteLoop._graph, em._run_sites

    def timed(fn):
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        return out, time.perf_counter() - t0

    def timed_run(self, step, n, kind="site"):
        _, secs = timed(lambda: run(self, step, n, kind))
        rec["runs"].setdefault(str(kind), []).append(secs)
        rec["sites"][str(kind)] = rec["sites"].get(str(kind), 0) + int(n)

    def timed_graph(self, step, kind, sites):
        fresh = (kind, sites) not in self.graphs
        out, secs = timed(lambda: graph(self, step, kind, sites))
        rec["capture_s"] += secs if fresh else 0.0
        return out

    def timed_run_sites(eng, loop, start, stop, draws):
        _, secs = timed(lambda: run_sites(eng, loop, start, stop, draws))
        rec["engine_loop"][0] += secs
        rec["engine_loop"][1] += stop - start

    SiteLoop.run, SiteLoop._graph, em._run_sites = timed_run, timed_graph, timed_run_sites
    try:
        yield rec
    finally:
        SiteLoop.run, SiteLoop._graph, em._run_sites = run, graph, run_sites


def _engine_classes(rec):
    """The engine's site loop by class from a ``_loop_timer`` record:
    ms/site of the steady runs, each update site's ms (a one-site run:
    the first eager, the second with its capture, then replays) and
    their median, and ms/site of the sites that run eagerly outside any
    run call (the growth phase, the last site)."""
    import numpy as np

    runs, sites = rec["runs"], rec["sites"]
    loop_s, loop_sites = rec["engine_loop"]
    in_runs = sum(sum(v) for v in runs.values())
    upd = [1e3 * x for x in runs.get("update", [])]
    return {
        "steady_ms_per_site": 1e3 * sum(runs.get("steady", [0.0])) / max(1, sites.get("steady", 0)),
        "steady_sites": sites.get("steady", 0),
        "update_ms_each": upd,
        "update_ms_median": float(np.median(upd)) if upd else None,
        "eager_sites": loop_sites - sum(sites.values()),
        "eager_ms_per_site": 1e3 * (loop_s - in_runs) / max(1, loop_sites - sum(sites.values())),
        "loop_ms_per_site": 1e3 * loop_s / max(1, loop_sites),
        "capture_s": rec["capture_s"],
    }


def graph_phase(device, root, data_dir, sg_dir, segment_size, buffer_size, stream_block, mesh_args, sg_sites,
                seed=0):
    """The site loops graphed (SITES_PER_GRAPH sites a CUDA graph, the
    default) and eager (sites_per_graph=0) in this call, each pair on the
    same inputs and generators: runner.infer_segment monolithic, streamed
    (``stream_block``) and marginal (seeds MARGINAL_SEEDS in one call) on
    batch 0 of phase 5's chromosome (segment_size + buffer_size),
    runner.infer_chromosome_meshed halo on phase 18's chromosome and mesh,
    and single_group.runner.estimate_parameters_and_regimes on the first
    ``sg_sites`` control CpGs of phase 5's chromosome (the CLI's defaults,
    both estimates on, an update every 200 sites). Every output file (npz
    arrays, logZ files, CSVs) equal bit for bit, K1's launches equal (T - 1
    for the marginal filter), its spill counts equal, the engine's logZ
    equal; ms/site of the loops (the filter and the backward pass apart for
    infer and the meshed run; the marginal call's seconds for both seeds)
    and peak memory of both; the engine's site loop by class of site
    (``_engine_classes``); then ``_chain_pairs``. Returns stats."""
    import numpy as np
    import torch
    from hygeia_tpu_torch.ops.site_graphs import SITES_PER_GRAPH
    from hygeia_tpu_torch.single_group.runner import estimate_parameters_and_regimes
    from hygeia_tpu_torch.two_group.runner import infer_chromosome_meshed, infer_segment
    from hygeia_tpu_torch.utils import io as hio

    T, N = segment_size + buffer_size, 50 * (2 * R + R * R)
    mesh_sites, mesh_seg, mesh_buf = mesh_args
    sg_in = os.path.join(root, "single_group_input")
    sub_in = os.path.join(root, "graph_sg_input")
    read = lambda name: hio.read_headed_matrix(os.path.join(sg_in, name))[:, :sg_sites].astype(np.int64)
    n_meth, n_total = read("n_methylated_reads_1.csv"), read("n_total_reads_1.csv")
    positions = hio.read_headed_column(os.path.join(sg_in, "genomic_positions_1.csv"))[:sg_sites].astype(np.int64)
    hio.write_headed_matrix(os.path.join(sub_in, "n_methylated_reads.csv"), n_meth, "sample")
    hio.write_headed_matrix(os.path.join(sub_in, "n_total_reads.csv"), n_total, "sample")
    hio.write_headed_column(os.path.join(sub_in, "genomic_positions.csv"), positions, "genomic_positions")

    def infer(out, K, block=None):
        return infer_segment(data_dir=data_dir, single_group_dir=sg_dir, results_dir=out, chrom="1", device=device,
                             batch=0, seed=seed, segment_size=segment_size, buffer_size=buffer_size,
                             streaming_blocks=block, sites_per_graph=K)

    def meshed(out, K):
        tim = {}
        infer_chromosome_meshed(data_dir=data_dir, single_group_dir=sg_dir, results_dir=out, chrom="5",
                                mesh_shape=MESH_SHAPE, device=device, boundary="halo", seed=MESH_SEEDS,
                                segment_size=mesh_seg, buffer_size=mesh_buf, timings=tim, sites_per_graph=K)
        return tim[N]

    def engine(out, K):
        os.makedirs(out, exist_ok=True)
        files = {k: os.path.join(out, v) for k, v in (
            ("regime_probabilities_csv_file", "regime_probs.csv"), ("theta_trace_csv_file", "theta_trace.csv"),
            ("p_csv_file", "p.csv"), ("omega_csv_file", "omega.csv"), ("kappa_csv_file", "kappa.csv"),
            ("theta_file", "theta.csv.gz"))}
        return estimate_parameters_and_regimes(
            n_methylated_reads_csv_file=os.path.join(sub_in, "n_methylated_reads.csv"),
            n_total_reads_csv_file=os.path.join(sub_in, "n_total_reads.csv"),
            genomic_positions_csv_file=os.path.join(sub_in, "genomic_positions.csv"), device=device,
            n_particles=SG_N, estimate_parameters=True, estimate_regime_probabilities=True,
            sites_per_graph=K, **files)

    def marginal(out, K):
        return infer_segment(data_dir=data_dir, single_group_dir=sg_dir, results_dir=out, chrom="1", device=device,
                             batch=0, seed=list(MARGINAL_SEEDS), segment_size=segment_size, buffer_size=buffer_size,
                             marginal=True, sites_per_graph=K)

    mesh_units = -(-max(1, -(-mesh_sites // mesh_seg)) // MESH_SHAPE[0]) * MESH_SHAPE[0] * len(MESH_SEEDS)
    paths = {
        "infer": (infer, "chrom_1_0", T),
        "streamed": (lambda out, K: infer(out, K, stream_block), "chrom_1_0", T),
        "marginal": (marginal, "chrom_1_0", T),
        "meshed_halo": (meshed, None, (mesh_seg + 2 * mesh_buf)),
        "engine": (engine, "", sg_sites),
    }
    stats = {"sites_per_graph": SITES_PER_GRAPH}
    for name, (run, sub, sites) in paths.items():
        got = {}
        for label, K in (("graphed", SITES_PER_GRAPH), ("eager", 0)):
            out = os.path.join(root, f"graph_{name}_{label}")
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            reset_launches()
            _sync(device)
            text = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text), (_loop_timer(device) if name == "engine"
                                                    else contextlib.nullcontext()) as rec:
                res = run(out, K)
            _sync(device)
            wall = time.perf_counter() - t0
            launches = launches_since_reset(None if name == "engine" else f"graphs_{name}_{label}",
                                            run=f"graphs_{name}_{label}")
            got[label] = {"out": out, "res": res, "wall_s": wall, "launches": launches,
                          "text": text.getvalue(), "classes": rec and _engine_classes(rec),
                          "peak": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None}
        g, e = got["graphed"], got["eager"]
        check(g["launches"] == e["launches"], f"graphs {name}: K1 launched {g['launches']} times graphed, "
                                              f"{e['launches']} eager")
        if name == "marginal":
            check(g["launches"] == sites - 1, f"graphs marginal: K1 launched {g['launches']} times for T={sites}")
        split = None  # (filter s, backward s) by label
        if name == "meshed_halo":
            n_files = sum(_same_files(os.path.join(g["out"], d), os.path.join(e["out"], d), f"graphs {name} {d}")
                          for d in sorted(os.listdir(g["out"])))
            split = {lab: (got[lab]["res"]["filter_s"], got[lab]["res"]["backward_s"]) for lab in got}
        else:
            n_files = _same_files(os.path.join(g["out"], sub), os.path.join(e["out"], sub), f"graphs {name}")
        if name == "infer":  # the runner's own filter and backward seconds
            split = {}
            for lab in got:
                secs = []
                for f in (f"optimal_time_{seed}.txt", f"optimal_time_backward_{seed}.txt"):
                    with open(os.path.join(got[lab]["out"], sub, f)) as fh:
                        secs.append(float(ast.literal_eval(fh.read())[N]))
                split[lab] = tuple(secs)
        loops = {lab: sum(split[lab]) if split else got[lab]["wall_s"] for lab in got}
        if name == "marginal":  # the runner's seconds of the call (a seed's share each), and the spill lines
            spills = {}
            for lab in got:
                spills[lab] = [ln for ln in got[lab]["text"].splitlines() if ln.startswith("marginal filter seed")]
                loops[lab] = 0.0
                for sd in MARGINAL_SEEDS:
                    with open(os.path.join(got[lab]["out"], sub, f"optimal_time_{sd}.txt")) as fh:
                        loops[lab] += float(ast.literal_eval(fh.read())[N])
            check(len(spills["graphed"]) == len(MARGINAL_SEEDS) and spills["graphed"] == spills["eager"],
                  f"graphs marginal: spill counts {spills}")
        if name == "engine":
            for field in ("log_normalizing_constant", "regime_probs", "theta_trace", "final_theta"):
                check(torch.equal(getattr(g["res"], field), getattr(e["res"], field)),
                      f"graphs engine: {field} differs graphed and eager")
        ms = {lab: 1e3 * loops[lab] / sites for lab in loops}
        units = {"meshed_halo": mesh_units, "marginal": len(MARGINAL_SEEDS)}.get(name, 1)
        stats[name] = {"sites": sites, "units": units, "files_equal": n_files,
                       "launches": g["launches"], "ms_per_site": ms, "speedup": ms["eager"] / ms["graphed"],
                       "wall_s": {lab: got[lab]["wall_s"] for lab in got},
                       "max_memory_allocated_bytes": {lab: got[lab]["peak"] for lab in got}}
        if split:
            stats[name]["filter_backward_ms_per_site"] = {
                lab: [1e3 * x / sites for x in split[lab]] for lab in got}
        print(f"graphs {name}: {sites} sites, {n_files} files equal bit for bit graphed and eager, "
              f"launches={g['launches']} both; loops {ms['graphed']:.3f} ms/site graphed, {ms['eager']:.3f} eager "
              f"({stats[name]['speedup']:.2f}x)"
              + ("".join(f"; {lab} filter {1e3 * split[lab][0] / sites:.3f} + backward "
                         f"{1e3 * split[lab][1] / sites:.3f} ms/site" for lab in got) if split else "")
              + f"; max_memory_allocated {g['peak']} graphed, {e['peak']} eager")
        if name == "engine":
            stats[name]["by_class"] = {lab: got[lab]["classes"] for lab in got}
            for lab in got:
                c = got[lab]["classes"]
                print(f"graphs engine {lab} by class: steady {c['steady_ms_per_site']:.3f} ms/site "
                      f"({c['steady_sites']} sites), update sites {c['update_ms_median']:.3f} ms each (median "
                      f"of {len(c['update_ms_each'])}; first two {[round(x, 3) for x in c['update_ms_each'][:2]]}), "
                      f"eager sites {c['eager_ms_per_site']:.3f} ms/site ({c['eager_sites']} sites), captures "
                      f"{c['capture_s']:.3f} s")
        if name == "marginal":
            stats[name]["spill_lines"] = spills["graphed"]
            print("graphs marginal: " + "; ".join(spills["graphed"]) + " (graphed and eager alike)")
    stats.update(_chain_pairs(device, root, sg_sites))
    return stats


def _chain_pairs(device, root, sg_sites, seed=0):
    """Both simulators' chains graphed (SITES_PER_GRAPH) and eager in this
    call on the same noise: simulate_two_groups's at the verb's defaults
    (T = 2,000) and simulate_data's at its model and ``sg_sites`` CpGs. The
    states equal bit for bit; ms/site of each (simulate_chain's call,
    the single-group one's table build included; graphed, also without
    its captures, timed apart by ``_loop_timer``) and peak memory of
    each."""
    import numpy as np
    import torch
    from hygeia_tpu_torch import cli
    from hygeia_tpu_torch.ops.site_graphs import SITES_PER_GRAPH
    from hygeia_tpu_torch.single_group import simulate as sg_sim
    from hygeia_tpu_torch.single_group.model import make_model, parameters_to_theta
    from hygeia_tpu_torch.single_group.runner import DEFAULT_MU, DEFAULT_OMEGA, DEFAULT_SIGMA, default_p
    from hygeia_tpu_torch.two_group import simulate as tg_sim
    from hygeia_tpu_torch.two_group.simulate_runner import simulation_params

    gen = lambda: torch.Generator(device=device).manual_seed(seed)
    args = cli.build_parser().parse_args(["simulate_two_groups", "--results_dir", os.path.join(root, "chains")])
    params, _n_c, _n_k = simulation_params(args, device)
    T2 = args.n_observations
    noise2 = tg_sim.draw_chain_noise(T2, params.n_regimes, generator=gen(), device=device)
    model = make_model(np.asarray(DEFAULT_MU), DEFAULT_SIGMA, 2, np.full(R, 2.0), d_max=4096, device=device)
    theta = torch.as_tensor(parameters_to_theta(default_p(R), np.asarray(DEFAULT_OMEGA), np.full(R, 2.0)),
                            dtype=torch.float32, device=device)
    noise1 = sg_sim.draw_chain_noise(sg_sites, R, generator=gen(), device=device)
    chains = {
        "simulate_two_groups_chain": (T2, lambda K: tg_sim.simulate_chain(params, noise2, K)),
        "simulate_data_chain": (sg_sites, lambda K: torch.stack(sg_sim.simulate_chain(model, theta, noise1, K))),
    }
    stats = {}
    for name, (sites, run) in chains.items():
        got, secs, capture, peak = {}, {}, {}, {}
        for label, K in (("graphed", SITES_PER_GRAPH), ("eager", 0)):
            torch.cuda.reset_peak_memory_stats(device)
            _sync(device)
            t0 = time.perf_counter()
            with _loop_timer(device) as rec:
                got[label] = run(K)
            _sync(device)
            secs[label] = time.perf_counter() - t0
            capture[label] = rec["capture_s"]
            peak[label] = torch.cuda.max_memory_allocated(device)
        check(torch.equal(got["graphed"], got["eager"]), f"graphs {name}: states differ graphed and eager")
        ms = {lab: 1e3 * secs[lab] / sites for lab in secs}
        replays = 1e3 * (secs["graphed"] - capture["graphed"]) / sites
        stats[name] = {"sites": sites, "states_equal": True, "ms_per_site": ms,
                       "speedup": ms["eager"] / ms["graphed"], "capture_s": capture["graphed"],
                       "graphed_ms_per_site_without_capture": replays, "max_memory_allocated_bytes": peak}
        print(f"graphs {name}: {sites} sites, states equal bit for bit graphed and eager; {ms['graphed']:.4f} "
              f"ms/site graphed ({replays:.4f} without its {capture['graphed']:.4f} s of captures), "
              f"{ms['eager']:.4f} eager ({stats[name]['speedup']:.2f}x); max_memory_allocated "
              f"{peak['graphed']} graphed, {peak['eager']} eager")
    return stats


def _world2_rank(rank, rendezvous, kw, out_dir, N, device_str):
    """One of phase 19's two ranks (torch.multiprocessing.spawn's target):
    gloo on the one card, both schemes through infer_chromosome_meshed;
    writes its launches, messages and chunks to out_dir/rank{rank}.json."""
    import torch
    from hygeia_tpu_torch.ops import cuda_backward_step, cuda_filter_step
    from hygeia_tpu_torch.ops.cuda_resampling import KERNEL
    from hygeia_tpu_torch.parallel.launcher import initialize_distributed
    from hygeia_tpu_torch.parallel.sharded import MESSAGES
    from hygeia_tpu_torch.two_group.runner import infer_chromosome_meshed

    device = torch.device(device_str)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    count_backward_sites()
    check(initialize_distributed(f"file://{rendezvous}", 2, rank, backend="gloo") == (rank, 2), "world 2: join")
    rec = {}
    for boundary in ("halo", "exchange"):
        reset_launches()
        tim = {}
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            infer_chromosome_meshed(**kw, boundary=boundary, results_dir=os.path.join(out_dir, boundary),
                                    device=device, timings=tim)
        t = tim[N]
        rec[boundary] = {"launches": KERNEL.launches, "k2_launches": cuda_filter_step.KERNEL.launches,
                         "k3_launches": cuda_backward_step.KERNEL.launches, "backward_sites": BACKWARD_SITES[0],
                         "messages": MESSAGES.rounds, "calls": MESSAGES.calls,
                         "chunks": t["chunks"], "wall_s": time.perf_counter() - t0,
                         **{k: t[k] for k in ("filter_s", "backward_s", "messages_s")}}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()


def world2_phase(device, root, n_sites, segment_size, buffer_size, seed=8):
    """Two ranks on the one card (torch.multiprocessing spawn, gloo: NCCL
    refuses two ranks on one GPU), mesh 4x2, halo and exchange, on a sixth
    seeded chromosome "6" at a cut depth, against world 1 in this process
    with chunks of a rank's units (on the card a batched reduction's order
    depends on a chunk's units): every npz array and logZ file equal bit
    for bit, each rank's K1 launches one chunk's formula, and the messages
    world 1's, each one torch.distributed call. Returns (stats, launches of
    both ranks)."""
    import numpy as np
    import torch.multiprocessing as mp
    from hygeia_tpu_torch.parallel.sharded import MESSAGES, expected_launches
    from hygeia_tpu_torch.two_group.runner import infer_chromosome_meshed

    data_dir, sg_dir, _, _ = make_dataset(root, n_sites, seed=seed, chrom="6")
    shutil.copy(os.path.join(sg_dir, "theta_1.csv.gz"), os.path.join(sg_dir, "theta_6.csv.gz"))
    N = 50 * (2 * R + R * R)
    n_blocks = -(-max(1, -(-n_sites // segment_size)) // MESH_SHAPE[0]) * MESH_SHAPE[0]
    bpd = n_blocks // MESH_SHAPE[0]
    kw = dict(data_dir=data_dir, single_group_dir=sg_dir, chrom="6", mesh_shape=MESH_SHAPE, seed=MESH_SEEDS,
              segment_size=segment_size, buffer_size=buffer_size)
    per_rank = {"halo": n_blocks * len(MESH_SEEDS) // 2, "exchange": MESH_SHAPE[0] * len(MESH_SEEDS) // 2}
    ref = {}
    for boundary in ("halo", "exchange"):
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            infer_chromosome_meshed(**kw, boundary=boundary, results_dir=os.path.join(root, "world1", boundary),
                                    device=device, max_units_per_call=per_rank[boundary])
        check(MESSAGES.calls == 0, "world 1 made torch.distributed calls")
        ref[boundary] = {"messages": MESSAGES.rounds, "launches": launches_since_reset(f"world1_{boundary}"),
                         "wall_s": time.perf_counter() - t0}
    out_dir = os.path.join(root, "world2")
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    mp.spawn(_world2_rank, args=(os.path.join(root, "world2_rendezvous"), kw, out_dir, N, str(device)), nprocs=2,
             join=True)
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    launches = 0
    for boundary in ("halo", "exchange"):
        want = expected_launches(boundary, segment_size, buffer_size, bpd, 1)
        for r, rec in enumerate(ranks):
            got = rec[boundary]
            check(got["chunks"] == [per_rank[boundary]], f"world 2 {boundary}: rank {r} chunks {got['chunks']}")
            check(got["launches"] == want, f"world 2 {boundary}: rank {r} launched {got['launches']}, formula {want}")
            check(got["k2_launches"] == got["launches"],
                  f"world 2 {boundary}: rank {r}'s K2 launched {got['k2_launches']} times, K1 {got['launches']}")
            K2_LAUNCHES["meshed_world2"] = K2_LAUNCHES.get("meshed_world2", 0) + got["k2_launches"]
            check(got["k3_launches"] == got["backward_sites"] > 0,
                  f"world 2 {boundary}: rank {r}'s K3 launched {got['k3_launches']} times for "
                  f"{got['backward_sites']} backward sites")
            K3_LAUNCHES["meshed_world2"] = K3_LAUNCHES.get("meshed_world2", 0) + got["k3_launches"]
            launches += got["launches"]
        got = ranks[0][boundary]
        check(got["messages"] == ref[boundary]["messages"] == got["calls"],
              f"world 2 {boundary}: {got['messages']} messages in {got['calls']} calls, world 1 "
              f"{ref[boundary]['messages']}")
        a_root, b_root = os.path.join(root, "world1", boundary), os.path.join(out_dir, boundary)
        batches = sorted(os.listdir(a_root))
        check(batches == sorted(os.listdir(b_root)), f"world 2 {boundary}: batch directories differ")
        n_arrays = 0
        for d in batches:
            names = sorted(os.listdir(os.path.join(a_root, d)))
            check(names == sorted(os.listdir(os.path.join(b_root, d))), f"world 2 {boundary}: {d}'s files differ")
            for name in names:
                pa, pb = os.path.join(a_root, d, name), os.path.join(b_root, d, name)
                if name.endswith(".npz"):
                    a, b = np.load(pa)["arr_0"], np.load(pb)["arr_0"]
                    check(a.dtype == b.dtype and np.array_equal(a, b), f"world 2 {boundary}: {d}/{name} differs")
                    n_arrays += 1
                elif name.startswith("log_normalizing"):
                    check(open(pa).read() == open(pb).read(), f"world 2 {boundary}: {d}/{name} differs")
        ref[boundary]["arrays_equal"] = n_arrays
    stats = {"sites": n_sites, "segment_size": segment_size, "buffer_size": buffer_size, "world1": ref,
             "ranks": ranks, "spawn_s": spawn_s, "launches": launches}
    print(f"world 2 (two ranks on one card, gloo): {n_sites} CpGs, segment {segment_size} + {buffer_size}; "
          f"{ref['halo']['arrays_equal']} + {ref['exchange']['arrays_equal']} npz arrays and the logZ files equal "
          f"world 1's bit for bit; messages halo {ref['halo']['messages']}, exchange {ref['exchange']['messages']} "
          f"(one call each); launches {[[rk[b]['launches'] for b in ('halo', 'exchange')] for rk in ranks]} a rank; "
          f"spawn {spawn_s:.2f} s (world 1: {ref['halo']['wall_s']:.2f} + {ref['exchange']['wall_s']:.2f} s)")
    return stats, launches


def mesh_run_phase(device, root, ctx, n_sites, batch_size, buffer_size, seeds=2):
    """run --two_group --mesh 4x2 --boundary exchange through the CLI on
    phase 12's preprocessed chromosome with phase 12's theta stage copied
    in (tests/test_orchestrator.py's way), so that INFER[mesh], aggregate
    and DMPs run: the sequential run's file set per batch, one chunk's
    launches, weighted_dmp_0.05.csv non-empty with at least half its
    positions in planted windows. Returns (stats, launches)."""
    import numpy as np
    from hygeia_tpu_torch import cli
    from hygeia_tpu_torch.parallel.sharded import expected_launches

    out = os.path.join(root, "pipeline_mesh")
    for stage in ("1_PREPROCESS", "2_ESTIMATE_PARAMETERS_AND_REGIMES"):
        shutil.copytree(os.path.join(ctx["out"], stage), os.path.join(out, stage))
    argv = ["run", "--two_group", "--output_dir", out, "--chroms", "3", "--cpg_file_path", ctx["cpg"],
            "--batch_size", str(batch_size), "--buffer_size", str(buffer_size), "--num_of_inference_seeds",
            str(seeds), "--mesh", f"{MESH_SHAPE[0]}x{MESH_SHAPE[1]}", "--boundary", "exchange", "--device", str(device)]
    for flag, paths, prefix in (("control", ctx["controls"], "c"), ("case", ctx["cases"], "k")):
        for i, p in enumerate(paths):
            argv += [f"--{flag}_data_path", p, f"--{flag}_id_names", f"{prefix}{i}"]
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(argv)
    wall = time.perf_counter() - t0
    launches = launches_since_reset("mesh_run")
    n_blocks = -(-max(1, -(-n_sites // batch_size)) // MESH_SHAPE[0]) * MESH_SHAPE[0]
    want = expected_launches("exchange", batch_size, buffer_size, n_blocks // MESH_SHAPE[0], 1)
    check(launches == want, f"mesh run: K1 launched {launches} times, the formula gives {want}")
    rows = [r.split("\t") for r in open(os.path.join(out, "trace.tsv")).read().splitlines()[1:]]
    ran = {r[0]: r for r in rows}
    for stage in ("INFER[mesh]", "AGGREGATE_RESULTS", "GET_DMPS"):
        check(stage in ran and ran[stage][3] == "False" and ran[stage][5] == "ok", f"mesh run: {stage} {ran.get(stage)}")
    check(ran["ESTIMATE_PARAMETERS_AND_REGIMES"][3] == "True", "mesh run: the theta stage ran again")
    seq = sorted(os.listdir(os.path.join(ctx["out"], "4_INFER", "chrom_3_0")))
    n_batches = 1 + n_sites // batch_size
    for b in range(n_batches):
        got = sorted(os.listdir(os.path.join(out, "4_INFER", f"chrom_3_{b}")))
        check(got == seq, f"mesh run: chrom_3_{b}'s files are not the sequential run's")
    with open(os.path.join(out, "6_GET_DMPS", "3", "weighted_dmp_0.05.csv")) as f:
        lines = f.read().splitlines()
    called = np.array([int(ln.split(",")[1]) for ln in lines[1:]], np.int64)
    check(called.size > 0, "mesh run: weighted_dmp_0.05.csv is empty")
    site = np.searchsorted(ctx["pos0"], called)
    precision = float(ctx["dmr"][site].mean())
    recall = float(np.isin(np.flatnonzero(ctx["dmr"]), site).mean())
    check(precision >= 0.5, f"mesh run: {precision:.3f} of the called DMPs lie in planted windows")
    stage_s = {r[0]: float(r[2]) for r in rows}
    stats = {"sites": n_sites, "batch_size": batch_size, "buffer_size": buffer_size, "batches": n_batches,
             "wall_s": wall, "stage_s": stage_s, "dmps_weighted_0.05": int(called.size), "precision": precision,
             "recall": recall, "launches": launches}
    print(f"mesh run: run --two_group --mesh 4x2 --boundary exchange on phase 12's {n_sites} CpGs, batches of "
          f"{batch_size} + {buffer_size}: launches={launches} (formula {want}); {wall:.2f} s, by stage {stage_s}; "
          f"file sets per batch the sequential run's; weighted_dmp_0.05: {called.size} positions, {precision:.3f} in "
          f"planted windows, recall {recall:.3f}")
    return stats, launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chrom_sites", type=int, default=105_000,
                    help="CpGs of the chromosome, all read by the single-group engine (default 105000)")
    ap.add_argument("--sites", type=int, default=100_000, help="infer's segment size (default 100000)")
    ap.add_argument("--buffer", type=int, default=5_000, help="infer's halo size (default 5000)")
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
    ap.add_argument("--marginal_sites", type=int, default=20_000,
                    help="infer --marginal's segment size (default 20000)")
    ap.add_argument("--marginal_buffer", type=int, default=1_000, help="infer --marginal's halo size (default 1000)")
    ap.add_argument("--simulate_data_sites", type=int, default=5_000,
                    help="CpGs of the simulate_data phase (default 5000)")
    ap.add_argument("--trace_sites", type=int, default=300, help="infer --trace_dir's segment size (default 300)")
    ap.add_argument("--trace_buffer", type=int, default=30, help="infer --trace_dir's halo size (default 30)")
    ap.add_argument("--mesh_sites", type=int, default=8_000,
                    help="CpGs of the meshed phase's chromosome (default 8000)")
    ap.add_argument("--mesh_segment", type=int, default=2_000, help="the meshed phase's segment (default 2000)")
    ap.add_argument("--mesh_buffer", type=int, default=200, help="the meshed phase's halo (default 200)")
    ap.add_argument("--world2_sites", type=int, default=2_400,
                    help="CpGs of the two-rank phase's chromosome (default 2400)")
    ap.add_argument("--world2_segment", type=int, default=600, help="the two-rank phase's segment (default 600)")
    ap.add_argument("--world2_buffer", type=int, default=60, help="the two-rank phase's halo (default 60)")
    ap.add_argument("--mesh_run_batch", type=int, default=3_300,
                    help="run --mesh's --batch_size on phase 12's chromosome (default 3300)")
    ap.add_argument("--mesh_run_buffer", type=int, default=330, help="run --mesh's --buffer_size (default 330)")
    ap.add_argument("--graph_sites", type=int, default=3_000,
                    help="the graphed-against-eager phase's infer segment (default 3000)")
    ap.add_argument("--graph_buffer", type=int, default=300,
                    help="the graphed-against-eager phase's infer halo (default 300)")
    ap.add_argument("--graph_stream_block", type=int, default=1_024,
                    help="the graphed-against-eager phase's --streaming_blocks (default 1024)")
    ap.add_argument("--graph_sg_sites", type=int, default=5_000,
                    help="CpGs of the graphed-against-eager phase's single-group engine (default 5000)")
    args = ap.parse_args(argv)
    if args.sites + args.buffer > args.chrom_sites:
        ap.error("the infer segment and halo must fit in the chromosome")
    if args.marginal_sites > args.sites:
        ap.error("the marginal segment must lie inside phase 7's segment")
    if args.sites + args.buffer <= args.stream_block:
        ap.error("the infer window must be longer than one streamed block")
    if args.trace_sites + args.trace_buffer > args.chrom_sites:
        ap.error("the traced segment and halo must fit in the chromosome")
    if args.graph_sites + args.graph_buffer > args.chrom_sites or args.graph_sg_sites > args.chrom_sites:
        ap.error("the graphed-against-eager phase's windows must fit in the chromosome")
    if args.graph_sites + args.graph_buffer <= args.graph_stream_block:
        ap.error("the graphed-against-eager phase's window must be longer than one streamed block")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to check", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "hygeia_tpu_torch")):
        print(f"chip_smoke: no hygeia_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    card = card_line()
    print(card)

    from hygeia_tpu_torch.ops import build, cuda_backward_step, cuda_engine_step, cuda_filter_step
    from hygeia_tpu_torch.ops.cuda_resampling import KERNEL
    from hygeia_tpu_torch.ops.probe import PROBE

    t0 = time.perf_counter()
    builds = build.build_all()  # one nvcc a source, all started together
    KERNEL.load()
    PROBE.load()
    cuda_filter_step.KERNEL.load()
    cuda_backward_step.KERNEL.load()
    cuda_engine_step.KERNEL.load()
    print(f"build: {[s.name for s in build.sources()]} in {time.perf_counter() - t0:.2f} s, one nvcc each in "
          f"parallel: " + ", ".join(f"{k} {v.seconds:.2f} s" for k, v in builds.items()))
    for name, info in builds.items():
        for line in info.log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  ptxas ({name}): {line.strip()}")

    max_err, times = kernel_phase(device)
    pr_stats, pr_launches = probe_phase(device)
    k2_err, k2_times = filter_step_phase(device)
    k3_checks, k3_times = backward_step_phase(device)
    k4_checks, k4_times = engine_step_phase(device)
    count_backward_sites()
    count_engine_sites()
    onsets = hazard_phase(device)
    offpath = offpath_phase(device)

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
        pl_stats, pl_launches, plb_launches, pl_ctx = pipeline_phase(device, root, args.pipeline_sites)
        sgp_stats, sgp_launches = sg_pipeline_phase(device, root, args.sg_pipeline_sites)
        mg_stats, mg_launches = marginal_phase(device, root, data_dir, sg_dir, dmr, args.marginal_sites,
                                               args.marginal_buffer, os.path.join(root, "results", "chrom_1_0"),
                                               stats)
        s2_stats, s2_launches = simulate_two_groups_phase(device, root)
        sd_stats, sd_launches, rep_launches = simulate_data_phase(device, root, args.simulate_data_sites)
        tr_stats, tr_launches = trace_phase(device, root, data_dir, sg_dir, args.trace_sites, args.trace_buffer)
        ms_stats, ms_launches = meshed_phase(device, root, args.mesh_sites, args.mesh_segment, args.mesh_buffer)
        w2_stats, w2_launches = world2_phase(device, root, args.world2_sites, args.world2_segment,
                                             args.world2_buffer)
        mr_stats, mr_launches = mesh_run_phase(device, root, pl_ctx, args.pipeline_sites, args.mesh_run_batch,
                                               args.mesh_run_buffer)
        gr_stats = graph_phase(device, root, data_dir, sg_dir, args.graph_sites, args.graph_buffer,
                               args.graph_stream_block, (args.mesh_sites, args.mesh_segment, args.mesh_buffer),
                               args.graph_sg_sites)
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
                     + plb_launches + sgp_launches + mg_launches + s2_launches + sd_launches + rep_launches
                     + tr_launches + ms_launches["halo"] + ms_launches["exchange"] + w2_launches + mr_launches),
        "launches_single_group": sg_launches,
        "launches_two_group": launches,
        "launches_streamed": st_launches,
        "launches_chromosome": ch_launches,
        "launches_robust": rb_launches,
        "launches_blocked": bl_launches,
        "launches_pipeline": pl_launches,
        "launches_single_group_pipeline": sgp_launches,
        "launches_marginal": mg_launches,
        "launches_pipeline_bucket_resume": plb_launches,
        "launches_simulate_two_groups": s2_launches,
        "launches_simulate_data_regimes": sd_launches,
        "launches_replicates": rep_launches,
        "launches_trace": tr_launches,
        "launches_meshed_halo": ms_launches["halo"],
        "launches_meshed_exchange": ms_launches["exchange"],
        "launches_meshed_world2": w2_launches,
        "launches_mesh_run": mr_launches,
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
                              "marginal": mg_stats["launches_per_site"],
                              "simulate_two_groups": s2_stats["launches_per_site"],
                              "simulate_data_regimes": sd_stats["launches_per_site"],
                              "replicates": rep_launches / (args.simulate_data_sites - 1),
                              "trace": tr_launches / (args.trace_sites + args.trace_buffer - 1)},
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
    }, {
        "name": "probe",
        "route": "cuda",
        "source": "hygeia_tpu_torch/csrc/probe.cu",
        "replaces": ".round4/pallas_smoke.py:11",
        "launches": pr_launches,
        "max_abs_err": pr_stats["max_abs_err"],
        "ms": pr_stats["ms"],
        "plain_ms": pr_stats["plain_ms"],
        "bound_ms": pr_stats["bound_ms"],
        "bound_by": pr_stats["bound_by"],
        "library_ms": None,
        "library": "no single PyTorch call computes it",
        "device_ms": pr_stats["device_ms"],
        "bytes": pr_stats["bytes"],
        "shape": "(8, 128) f32, one block",
    }, {
        "name": "filter_step",
        "route": "cuda",
        "source": "hygeia_tpu_torch/csrc/filter_step.cu",
        # No TPU kernel: the JAX package composes the step from XLA ops.
        "replaces": "hygeia_tpu/two_group/filter.py:386",
        # Every two-group run's K2 launches, each checked equal to K1's.
        "launches": sum(K2_LAUNCHES.values()),
        "launches_by_path": K2_LAUNCHES,
        "max_abs_err": k2_err,
        "shape": "U=2 N=2400 M=50 R=6 (the benchmark cell's)",
        **{k: k2_times["two_group_cell"][k] for k in ("ms", "plain_ms", "device_ms", "plain_device_ms", "bytes",
                                                       "bound_ms", "bound_by")},
        "library_ms": None,
        "library": "no single PyTorch call computes it",
        "by_shape": k2_times,
    }, {
        "name": "backward_step",
        "route": "cuda",
        "source": "hygeia_tpu_torch/csrc/backward_step.cu",
        # No TPU kernel: the JAX package composes the step from XLA ops.
        "replaces": "hygeia_tpu/two_group/backward.py",
        # Every two-group run's K3 launches, each checked equal to its backward sites.
        "launches": sum(K3_LAUNCHES.values()),
        "launches_by_path": K3_LAUNCHES,
        "checks": k3_checks,
        "shape": "U=2 B=25 N=2400 R=6 (the benchmark cell's)",
        **{k: k3_times["two_group_cell"][k] for k in ("ms", "plain_ms", "device_ms", "plain_device_ms", "bytes",
                                                       "bound_ms", "bound_by")},
        "library_ms": None,
        "library": "no single PyTorch call computes it",
        "by_shape": k3_times,
    }, {
        "name": "engine_step",
        "route": "cuda",
        "source": "hygeia_tpu_torch/csrc/engine_step.cu",
        # No TPU kernel: the JAX package composes the step from XLA ops.
        "replaces": "hygeia_tpu/single_group/engine.py",
        # Every run's K4 launches, three a single-group engine site at
        # capacity on the card, each checked against its sites; the growth
        # sites take the plain composition.
        "launches": sum(K4_LAUNCHES.values()),
        "launches_by_path": K4_LAUNCHES,
        "plain_sites_by_path": PLAIN_ENGINE_SITES,
        "checks": k4_checks,
        "max_abs_err": max(v[0] for gaps in k4_checks.values() for v in gaps.values()),
        "shape": f"U=1 N={SG_N} S=128 R={R} D=36 (the theta cell's)",
        **{k: k4_times["single_group_cell"][k] for k in ("ms", "plain_ms", "device_ms", "plain_device_ms", "bytes",
                                                          "bound_ms", "bound_by")},
        "library_ms": None,
        "library": "no single PyTorch call computes it",
        "by_shape": k4_times,
    }], "card": card, "hazard_onsets": onsets, "single_group": sg_stats, "slice": stats,
        "streamed": st_stats, "chromosome": ch_stats, "robust": rb_stats, "blocked": bl_stats,
        "pipeline": pl_stats, "single_group_pipeline": sgp_stats, "marginal": mg_stats, "offpath": offpath,
        "simulate_two_groups": s2_stats, "simulate_data": sd_stats, "trace": tr_stats,
        "meshed": ms_stats, "world2": w2_stats, "mesh_run": mr_stats, "graphs": gr_stats,
        "smoke_s": time.perf_counter() - t_start}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
