"""Runs one benchmark cell once and builds its result line.

Everything a cell needs is found by name:
- ``BENCHMARK.json`` names the cell's configuration, traffic and metrics;
- ``perfbench/workloads/<cell>.json`` names the driver, and holds the
  check's sample size, the limits of the numbers it compares and the
  traced stretch;
- ``perfbench/configs/<config>.json`` and ``perfbench/traffic/<traffic>.json``
  hold the settings the driver and the input generator read;
- ``perfbench/drivers/<driver>.py`` drives the port's entry point: its
  ``Driver(ctx)`` has ``setup()``, ``call(k)`` (one call of the window,
  returning its work, and under ``untimed_s`` the seconds inside it that
  the check's own copies took, which come off the call's wall),
  ``spans(k)``, ``shapes`` and ``check()`` (the numbers compared, each
  with its limit);
- ``perfbench/metrics/<metric>.py`` reads one metric from a ``Run``:
  ``read(run)`` returns a number, or None where it finds nothing to read.

The window runs whole calls until ``seconds`` have passed; the rate
metrics divide the calls' work by their wall. Set-up (imports, the CUDA
context, the inputs, the kernel's build or load, the warm-up call) is
``setup_s``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hygeia_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(bench, cell_name):
    """(cell, config, traffic) dicts of a cell named in ``bench``."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in entries:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json")
    entry = entries[cell_name]
    cell = {**load_json(BENCH_DIR / "workloads" / f"{cell_name}.json"), **entry}
    config = load_json(BENCH_DIR / "configs" / f"{entry['config']}.json")
    traffic = load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    return cell, config, traffic


def metrics_of(bench, cell_name, kind):
    """The metric entries of ``kind`` ("end_to_end" or "per_layer") that
    the cell reports: those listing it, and those with no list."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]


def reader(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", "perfbench_metric_" + name.replace(".", "_"))


class Run:
    """What one run measured, for the metric readers: the calls' walls,
    work and program spans, set-up seconds, the device trace summary (or
    None), the window's memory peak and the driver's kernel shapes."""

    def __init__(self, cell, config, traffic):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.calls = []
        self.setup_s = None
        self.trace = None
        self.memory_peak_bytes = None
        self.shapes = {}

    def untraced(self):
        """The calls the profiler did not touch (all of them in a run with
        no trace): the program's spans and walls are read from these."""
        calls = [c for c in self.calls if not c.get("traced")]
        return calls or self.calls

    def total(self, section, key, calls=None):
        vals = [c[section][key] for c in (self.calls if calls is None else calls) if key in c.get(section, {})]
        return sum(vals) if vals else None

    @property
    def wall_s(self):
        return sum(c["wall_s"] for c in self.calls)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, a JAX library's or
    the JAX package's, compared whole."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def run_cell(*, bench, cell_name, seed, seconds, trace, t_start, device="cuda", overrides=None,
             workdir=None, log=None, after_window=None):
    """Run cell ``cell_name`` once: set-up, a window of ``seconds``, the
    check. Returns (result dict, checks list). ``overrides`` update the
    configuration, traffic and cell (the CPU tests' small sizes);
    ``workdir`` holds the run's inputs and outputs (default: a new
    directory under TMPDIR, removed at the end); ``after_window(driver)``
    is called once the window has closed, before the check (the control's
    readings)."""
    import shutil

    import torch

    log = log or (lambda *a: print(*a, file=sys.stderr))
    cell, config, traffic = cell_spec(bench, cell_name)
    for section, upd in (overrides or {}).items():
        {"config": config, "traffic": traffic, "cell": cell}[section].update(upd)
    device = torch.device(device)
    own_dir = workdir is None
    workdir = Path(workdir or tempfile.mkdtemp(prefix="perfbench_"))
    run = Run(cell, config, traffic)
    driver_mod = load_module(BENCH_DIR / "drivers" / f"{cell['driver']}.py", "perfbench_driver_" + cell["driver"])
    ctx = SimpleNamespace(cell=cell, config=config, traffic=traffic, seed=int(seed), device=device,
                          workdir=workdir, log=log)
    attempted = failed = 0
    try:
        drv = driver_mod.Driver(ctx)
        drv.setup()
        run.shapes = drv.shapes
        tracer = None
        if trace:
            from perfbench.loop_trace import LoopTracer

            tracer = LoopTracer(**cell["trace"])
            if device.type == "cuda":
                LoopTracer.prime(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        run.setup_s = time.perf_counter() - t_start
        t_window = time.perf_counter()
        k = 0
        while time.perf_counter() - t_window < seconds:
            attempted += 1
            t0 = time.perf_counter()
            traced = tracer is not None and k == 0  # the first call; the later ones run untraced
            try:
                if traced:
                    with tracer:
                        work = drv.call(k)
                else:
                    work = drv.call(k)
            except Exception:  # a failed call ends the window and the run is not correct
                failed += 1
                log(traceback.format_exc())
                break
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            untimed = work.pop("untimed_s", 0.0)
            run.calls.append({"wall_s": time.perf_counter() - t0 - untimed, "untimed_s": untimed,
                              "work": work, "traced": traced})
            log(f"call {k}: {run.calls[-1]['wall_s']:.4f} s (less the check's copies, {untimed:.4f} s), "
                f"work {work}")
            k += 1
        if device.type == "cuda":
            run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
        for i, c in enumerate(run.calls):
            c["spans"] = drv.spans(i)
        if tracer is not None:
            run.trace = tracer.summary()
            log(f"trace: device busy {run.trace['busy_s']:.6f} s of {run.trace['window_s']:.6f} s, "
                f"{run.trace['profiler_s']:.6f} s of the profiler's own stalls left out")
        if after_window is not None:
            after_window(drv)
        t_check = time.perf_counter()
        checks = drv.check(len(run.calls))
        log(f"check: {time.perf_counter() - t_check:.3f} s over {len(run.calls)} calls")
    finally:
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(bench, cell_name, kind):
        value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = failed == 0 and bool(run.calls) and all(c["value"] <= c["limit"] for c in checks)
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device_block(device, run)}
    if trace and run.trace is not None:
        result["breakdown"] = breakdown(run.trace)
    return result, checks


def device_block(device, run):
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
           "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace is not None:
        out["busy_s"] = run.trace["busy_s"]
        out["window_s"] = run.trace["window_s"]
    return out


def breakdown(trace):
    ops = sorted(trace["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
    return {"device_ops": [[name, secs] for name, (_, secs) in ops],
            "idle_gaps": [[name, secs] for name, secs in trace["gaps"][:10]]}


def result_line(result, checks, card):
    """The result's JSON line: the result, the card, and last the checks,
    each number compared with its limit."""
    out = dict(result)
    out["card"] = card
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return json.dumps(out)


def check_lines(checks):
    return [f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})" for c in checks]
