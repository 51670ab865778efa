"""The CPU tests' small run: the cell's widths (R, M, N, B, U) on a short
chromosome, driven through the harness with the card's look skipped."""

from __future__ import annotations

import time

from perfbench import harness

CELL = "infer.seg.2seeds"
TINY = {"traffic": {"chromosome_sites": 2400, "warmup_sites": 150},
        "config": {"segment_size": 400, "buffer_size": 40},
        "cell": {"check": {"sites_per_unit": 12}}}


def bench():
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


def run(seed=11, seconds=1e-6, after_window=None, bench_doc=None, cell=CELL, trace=False):
    return harness.run_cell(bench=bench_doc or bench(), cell_name=cell, seed=seed, seconds=seconds,
                            trace=trace, t_start=time.perf_counter(), device="cpu", overrides=TINY,
                            after_window=after_window)
