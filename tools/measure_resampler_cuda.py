#!/usr/bin/env python3
"""Times the CUDA optimal resampler of hygeia_tpu_torch on one GPU: device
time, stage breakdown, enqueue cost and launch floor, for one source tree
or for two in turns.

    python3 tools/measure_resampler_cuda.py                      # this tree
    python3 tools/measure_resampler_cuda.py --old_tree DIR       # DIR, this, this, DIR

Each turn is a process of its own (``--side``) that builds
``<tree>/hygeia_tpu_torch/csrc/optimal_resampling.cu`` twice with nvcc for
sm_90a, plain and with ``-DHYGEIA_STAGE_CLOCKS``, and measures, at the
shapes the two main paths launch the kernel at (N=250/M=244 and N=2400/M=50)
and at N=7200/M=150:

- ``device_us``: CUDA events around 100 launches into preallocated outputs
  through the library's C entry, queued behind a spin on the card so that
  the host's enqueue rate does not show, best of 3;
- ``stage_cycles``: clock64() stamps of block 0 after each stage (load,
  top-(M+1), tail and suffix masses, threshold scan, prefix scan, selection,
  stores), mean of 20 launches, where the source has the stamps;
- ``enqueue_us``: host clock over 1,000 calls of the tree's Python wrapper
  with no synchronisation in between, i.e. host time per enqueue; with two
  trees also ``enqueue_in_turns_us``: the other tree's wrapper module
  loaded beside this one in one process (both launching this tree's
  kernel) and timed in turns other, this, this, other, three rounds, best
  of each, because host speed differs between processes;
- ``launch_floor_us``: the same two timings for an empty one-block launch,
  where the library has one;
- ``topk_us``: torch.topk(lw, M + 1), the yardstick of the first stage only;
- host microseconds of the wrapper's ingredients (allocations, views, the
  stream lookup, the device context).

Every side also resamples one seeded set of inputs and saves the outputs;
with two trees the parent process reports whether they are equal bit for
bit. Results go to stdout and to <out_dir>/resampler_measure.json
(``--out_dir``, default measure_out/ in the repository, which .gitignore lists).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [  # label, U, N, M, dead fraction
    ("single_group", 1, 250, 244, 0.0),
    ("single_group_u8", 8, 250, 244, 0.0),
    ("two_group", 1, 2400, 50, 0.2),
    ("two_group_u32", 32, 2400, 50, 0.2),
    ("two_group_m150", 1, 7200, 150, 0.2),
]
STAGES = ["load", "top", "tail_suffix", "threshold", "prefix_scan", "selection", "stores"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _inputs(torch, np, U, N, M, dead, device, seed=0):
    rng = np.random.default_rng(seed)
    lw = rng.gumbel(size=(U, N)).astype(np.float32)
    lw = np.where(rng.uniform(size=(U, N)) < dead, -np.inf, lw).astype(np.float32)
    t = torch.from_numpy(lw).to(device)
    lw = (t - torch.logsumexp(t, dim=-1, keepdim=True)).contiguous()
    g = torch.Generator(device=device).manual_seed(seed)
    return lw, torch.rand((U,), generator=g, device=device), torch.rand((U, M), generator=g, device=device)


def _build(source, out_dir, tag, defines):
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libresampler_{tag}_{os.getpid()}.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    cmd = [nvcc, *NVCC_FLAGS, *[f"-D{d}" for d in defines], "-o", lib, source]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _load(lib):
    dll = ctypes.CDLL(lib)
    vp, i = ctypes.c_void_p, ctypes.c_int
    dll.hygeia_optimal_resampling.argtypes = [vp, vp, vp, i, i, i, vp, vp, vp, vp, vp, vp]
    dll.hygeia_optimal_resampling.restype = i
    return dll


def side(tree, label, out_dir, other_wrapper=None):
    import numpy as np
    import torch

    sys.path.insert(0, tree)
    device = torch.device("cuda", 0)
    torch.cuda.init()
    source = os.path.join(tree, "hygeia_tpu_torch", "csrc", "optimal_resampling.cu")
    build_dir = os.path.join(out_dir, "measure_build")
    t0 = time.perf_counter()
    jobs = [_build(source, build_dir, "plain", []),
            _build(source, build_dir, "clocks", ["HYGEIA_STAGE_CLOCKS"])]
    logs = []
    for lib, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib}:\n{err}")
        logs.append(err)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    result = {"label": label, "tree": tree, "build_s": time.perf_counter() - t0,
              "sm_clock_idle_and_max": clock,
              "ptxas": [l.strip() for l in logs[0].splitlines() if "registers" in l or "spill" in l]}
    plain, clocks = _load(jobs[0][0]), _load(jobs[1][0])
    has_clocks = hasattr(clocks, "hygeia_set_stage_clocks")
    stream = torch.cuda.current_stream(device).cuda_stream

    def outputs(U, M):
        return (torch.empty((U, M), dtype=torch.int32, device=device),
                torch.empty((U, M), dtype=torch.float32, device=device),
                torch.empty((U, M), dtype=torch.int32, device=device),
                torch.empty((U,), dtype=torch.float32, device=device),
                torch.empty((U,), dtype=torch.bool, device=device))

    def raw_launcher(dll, lw, us, um, U, N, M, outs):
        args = (lw.data_ptr(), us.data_ptr(), um.data_ptr(), U, N, M, *[o.data_ptr() for o in outs], stream)
        fn = dll.hygeia_optimal_resampling

        def go():
            rc = fn(*args)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")
        return go

    def events_us(go, n=100, repeats=3):
        """Device microseconds per launch: the launches queue up behind a
        few milliseconds of spinning on the card, so the events time the
        card and not the host that enqueues."""
        best = float("inf")
        for _ in range(repeats):
            for _ in range(10):
                go()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(20_000_000)
            a.record()
            for _ in range(n):
                go()
            b.record()
            torch.cuda.synchronize(device)
            best = min(best, 1e3 * a.elapsed_time(b) / n)
        return best

    def host_us(go, n=1000, repeats=3):
        best = float("inf")
        for _ in range(repeats):
            for _ in range(20):
                go()
            torch.cuda.synchronize(device)
            t = time.perf_counter()
            for _ in range(n):
                go()
            best = min(best, 1e6 * (time.perf_counter() - t) / n)
            torch.cuda.synchronize(device)
        return best

    from hygeia_tpu_torch.ops import cuda_resampling as cr

    cr.KERNEL.load()  # the tree's own build, through its wrapper
    other = None
    if other_wrapper:
        import importlib.util

        spec = importlib.util.spec_from_file_location("other_cuda_resampling", other_wrapper)
        other = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(other)
        other.KERNEL.load()
    shapes = {}
    saved = {}
    for name, U, N, M, dead in SHAPES:
        lw, us, um = _inputs(torch, np, U, N, M, dead, device)
        outs = outputs(U, M)
        go = raw_launcher(plain, lw, us, um, U, N, M, outs)
        go()
        torch.cuda.synchronize(device)
        saved[name] = [o.cpu() for o in outs]
        entry = {"U": U, "N": N, "M": M, "device_us": events_us(go)}
        if has_clocks:
            buf = torch.zeros((U, 8), dtype=torch.int64, device=device)
            clocks.hygeia_set_stage_clocks.argtypes = [ctypes.c_void_p]
            clocks.hygeia_set_stage_clocks(buf.data_ptr())
            go_c = raw_launcher(clocks, lw, us, um, U, N, M, outs)
            acc = np.zeros(7)
            for _ in range(25):
                go_c()
                torch.cuda.synchronize(device)
            for _ in range(20):
                go_c()
                torch.cuda.synchronize(device)
                acc += np.diff(buf[0].cpu().numpy().astype(np.float64))
            entry["stage_cycles"] = dict(zip(STAGES, (acc / 20).round(1).tolist()))
            entry["cycles"] = float(acc.sum() / 20)
        entry["enqueue_us"] = host_us(lambda: cr.optimal_resampling_cuda(lw, M, us, um))
        if other is not None:
            mine, theirs = float("inf"), float("inf")
            for _ in range(3):
                theirs = min(theirs, host_us(lambda: other.optimal_resampling_cuda(lw, M, us, um), repeats=1))
                mine = min(mine, host_us(lambda: cr.optimal_resampling_cuda(lw, M, us, um), repeats=1))
                mine = min(mine, host_us(lambda: cr.optimal_resampling_cuda(lw, M, us, um), repeats=1))
                theirs = min(theirs, host_us(lambda: other.optimal_resampling_cuda(lw, M, us, um), repeats=1))
            entry["enqueue_in_turns_us"] = {"this": mine, "other": theirs}
        entry["wrapper_events_us"] = events_us(lambda: cr.optimal_resampling_cuda(lw, M, us, um))
        entry["topk_us"] = events_us(lambda: torch.topk(lw, M + 1))
        shapes[name] = entry
    result["shapes"] = shapes
    # More inputs for the bit-for-bit comparison of two trees: scales, dead
    # slots, fewer live weights than M, exact ties, the engine's growth phase.
    for U, N, M in ((1, 250, 244), (8, 250, 244), (1, 2400, 50), (32, 2400, 50), (2, 7200, 150),
                    (1, 2049, 1000), (2, 24000, 500), (5, 1000, 127), (2, 100, 127), (3, 240, 5),
                    (1, 2400, 1), (3, 300, 290), (132, 2400, 50)):
        rows = []
        rng = np.random.default_rng(N + M)
        for trial in range(6):
            g = rng.gumbel(size=(U, N)).astype(np.float32) * (1.0 + 2 * trial)
            rows.append(np.where(rng.uniform(size=(U, N)) < 0.2 * (trial % 2), -np.inf, g))
        for live in (3, 10, 12, 126, 246):
            g = np.full((U, N), -np.inf, np.float32)
            g[:, :min(live, N)] = rng.gumbel(size=(U, min(live, N)))
            rows.append(g)
        rows.append(np.zeros((U, N), np.float32))
        rows.append(np.round(rng.gumbel(size=(U, N))).astype(np.float32))
        gen = torch.Generator(device=device).manual_seed(N)
        for c, g in enumerate(rows):
            t = torch.from_numpy(np.asarray(g, np.float32)).to(device)
            lw = (t - torch.logsumexp(t, dim=-1, keepdim=True)).contiguous()
            us = torch.rand((U,), generator=gen, device=device)
            um = torch.rand((U, M), generator=gen, device=device)
            outs = outputs(U, M)
            raw_launcher(plain, lw, us, um, U, N, M, outs)()
            torch.cuda.synchronize(device)
            saved[f"U{U}_N{N}_M{M}_case{c}"] = [o.cpu() for o in outs]
    torch.save(saved, os.path.join(out_dir, f"resampler_outputs_{label}.pt"))

    if hasattr(plain, "hygeia_empty_launch"):
        plain.hygeia_empty_launch.argtypes = [ctypes.c_void_p]
        empty = lambda: plain.hygeia_empty_launch(stream)
        result["launch_floor_us"] = {"device": events_us(empty, n=1000), "host": host_us(empty)}

    # The wrapper's ingredients, host microseconds each.
    U, M = 1, 244
    ws = torch.empty((3 * U * M + 2 * U,), dtype=torch.int32, device=device)

    def five_empties():
        outputs(U, M)

    def one_empty_split_views():
        w = torch.empty((3 * U * M + 2 * U,), dtype=torch.int32, device=device)
        a, b, c, d, e = w.split((U * M, U * M, U * M, U, U))
        return a.view(U, M), b.view(torch.float32).view(U, M), c.view(U, M), d.view(torch.float32), e.view(torch.bool)[:U]

    ingredients = {
        "five_torch_empty": five_empties,
        "one_empty_split_views": one_empty_split_views,
        "empty_3UM_unbind_view": lambda: torch.empty((3, U, M), dtype=torch.int32, device=device).unbind(0)[1].view(torch.float32),
        "empty_like": lambda: torch.empty_like(ws),
        "new_empty": lambda: ws.new_empty((U, M)),
        "two_small_empty": lambda: (torch.empty((U,), dtype=torch.float32, device=device), torch.empty((U,), dtype=torch.bool, device=device)),
        "one_torch_empty": lambda: torch.empty((734,), dtype=torch.int32, device=device),
        "split_5": lambda: ws.split((U * M, U * M, U * M, U, U)),
        "view_2d": lambda: ws.view(2, -1),
        "current_stream_cuda_stream": lambda: torch.cuda.current_stream(device).cuda_stream,
        "current_stream_noarg": lambda: torch.cuda.current_stream().cuda_stream,
        "raw_stream_private": lambda: torch._C._cuda_getCurrentRawStream(0),
        "current_device": torch.cuda.current_device,
        "data_ptr": ws.data_ptr,
        "torch_rand_244": lambda: torch.rand((1, 244), device=device),
        "supports": lambda: cr.supports(250, 244),
    }

    def with_ctx():
        with torch.cuda.device(device):
            pass
    ingredients["device_context"] = with_ctx
    result["host_us"] = {k: host_us(v) for k, v in ingredients.items()}
    print("SIDE_JSON " + json.dumps(result))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old_tree", help="a checkout of another commit to time in turns with this tree")
    ap.add_argument("--out_dir", default=os.path.join(HERE, "measure_out"), help="where results and builds go")
    ap.add_argument("--side", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--tree", default=HERE, help=argparse.SUPPRESS)
    ap.add_argument("--label", default="new", help=argparse.SUPPRESS)
    ap.add_argument("--other_wrapper", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side:
        side(os.path.abspath(args.tree), args.label, os.path.abspath(args.out_dir), args.other_wrapper)
        return 0

    out_dir = os.path.abspath(args.out_dir)
    os.makedirs(out_dir, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    turns = [("new", HERE)]
    if args.old_tree:
        old_tree = os.path.abspath(args.old_tree)
        turns = [("old", old_tree), ("new", HERE), ("new2", HERE), ("old2", old_tree)]
    results = []
    for label, tree in turns:
        cmd = [sys.executable, os.path.abspath(__file__), "--side", "--tree", tree, "--label", label,
               "--out_dir", out_dir]
        if args.old_tree and tree == HERE:
            cmd += ["--other_wrapper", os.path.join(
                os.path.abspath(args.old_tree), "hygeia_tpu_torch", "ops", "cuda_resampling.py")]
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-6000:])
            raise SystemExit(f"side {label} failed")
        line = [l for l in proc.stdout.splitlines() if l.startswith("SIDE_JSON ")][-1]
        results.append(json.loads(line[len("SIDE_JSON "):]))
    for r in results:
        print(f"== {r['label']} ({r['tree']}) build {r['build_s']:.1f} s, "
              f"SM clock idle, max: {r['sm_clock_idle_and_max']}")
        for p in r["ptxas"]:
            print("   ptxas:", p)
        for name, e in r["shapes"].items():
            print(f"  {name:16s} U={e['U']:<3d} N={e['N']:<5d} M={e['M']:<4d} device {e['device_us']:8.2f} us  "
                  f"enqueue {e['enqueue_us']:7.2f} us  wrapper(events) {e['wrapper_events_us']:7.2f} us  "
                  f"topk {e['topk_us']:7.2f} us")
            if "enqueue_in_turns_us" in e:
                t = e["enqueue_in_turns_us"]
                print(f"      enqueue in turns, one process: this tree's wrapper {t['this']:.2f} us, "
                      f"the other tree's {t['other']:.2f} us")
            if "stage_cycles" in e:
                tot = e["cycles"]
                print("      stages (cycles, share): " + ", ".join(
                    f"{k} {v:.0f} ({100 * v / tot:.0f}%)" for k, v in e["stage_cycles"].items()) + f"; all {tot:.0f}")
        if "launch_floor_us" in r:
            print(f"  empty launch: device {r['launch_floor_us']['device']:.2f} us, host {r['launch_floor_us']['host']:.2f} us")
        print("  host us:", {k: round(v, 2) for k, v in r["host_us"].items()})
    if args.old_tree:
        import torch

        a = torch.load(os.path.join(out_dir, "resampler_outputs_old.pt"))
        b = torch.load(os.path.join(out_dir, "resampler_outputs_new.pt"))
        names = ["parents", "new_w", "top_idx", "log_c", "bad"]
        differing = 0
        for shape in a:
            same = {n: bool(torch.equal(x, y)) for n, x, y in zip(names, a[shape], b[shape])}
            if not all(same.values()):
                differing += 1
                frac = {n: float((x != y).double().mean()) for n, x, y in zip(names, a[shape], b[shape])}
                print(f"old vs new outputs DIFFER at {shape}: share of entries {frac}")
        print(f"old vs new outputs: {len(a) - differing} of {len(a)} input sets equal bit for bit in all five outputs")
    with open(os.path.join(out_dir, "resampler_measure.json"), "w") as f:
        json.dump({"card": card, "turns": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
