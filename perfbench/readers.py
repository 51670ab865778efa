"""Generic metric readers: each metric file under ``metrics/`` binds one
of these (or its own) as ``read(run)``. A reader returns None where the
run holds nothing for it to read, and the harness then leaves the metric
out of the result line."""

from __future__ import annotations

from perfbench import peaks


def rate(work_key):
    """Work ``work_key`` of the window's calls over their wall."""
    def read(run):
        work = run.total("work", work_key)
        return None if work is None or not run.calls else work / run.wall_s
    return read


def setup_s(run):
    return run.setup_s


def ms_per_site(span_key):
    """A program span's milliseconds over the loop sites of the calls
    the profiler did not touch."""
    def read(run):
        calls = run.untraced()
        span, sites = run.total("spans", span_key, calls), run.total("work", "sites", calls)
        return None if span is None or not sites else 1e3 * span / sites
    return read


def host_s_per_call(*span_keys):
    """A call's wall minus its program spans, averaged over the calls the
    profiler did not touch."""
    def read(run):
        calls = run.untraced()
        spans = [run.total("spans", k, calls) for k in span_keys]
        if not calls or any(s is None for s in spans):
            return None
        return (sum(c["wall_s"] for c in calls) - sum(spans)) / len(calls)
    return read


def k1_roofline_pct(run):
    """K1's byte bound over its mean device time a launch, in % (K1 is
    bound by memory)."""
    if run.trace is None or "k1" not in run.shapes:
        return None
    hits = [v for name, v in run.trace["kernels"].items() if "optimal_resampling_kernel" in name]
    launches, secs = sum(v[0] for v in hits), sum(v[1] for v in hits)
    if not launches or secs <= 0:
        return None
    s = run.shapes["k1"]
    return 100.0 * peaks.k1_bound_s(s["units"], s["n"], s["m"]) / (secs / launches)


def idle_pct(run):
    """Share of the traced window in which no device operation ran, %."""
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def busy_ms_per_site(run):
    """Device-busy milliseconds a traced loop site (the filter's and the
    backward pass's sites together): the device's work, whatever pace
    the host sets."""
    if run.trace is None or not run.trace.get("sites"):
        return None
    return 1e3 * run.trace["busy_s"] / run.trace["sites"]


def peak_mem_gib(run):
    return None if run.memory_peak_bytes is None else run.memory_peak_bytes / 2**30
