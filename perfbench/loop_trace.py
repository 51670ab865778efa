"""The traced run's device trace: ``torch.profiler`` over one stretch of
each site loop.

A whole INFER call runs ~300 small kernels a site over 11,000 sites, some
3 million device events, more than the profiler can hold and reduce inside
a run's time limit. So a traced run profiles ``stretches`` fixed stretches of every site loop
the port runs (``hygeia_tpu_torch.ops.site_graphs.SiteLoop``), each of
``sites`` sites, the j-th from site ``start_site + j * stride`` on: the
loop's ``run(step, n)`` is split into calls, every stretch one of them,
inside the profiler. The split replays the same graphs in the same order
as one call does (every part but the last is whole graphs, after the
first site), so the program draws and computes the same numbers.

The traced window is the sum of those stretches, each timed by the host
clock between two device synchronisations, less the idle time in which
the profiler itself held the host (its buffer requests and flushes,
``PROFILER_OVERHEAD``); device busy time is the union of the device
events' intervals inside them.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict

import torch

# Host events that are the profiler's own work, not the program's: while
# one runs, the host launches nothing, and the device idles for tracing.
PROFILER_OVERHEAD = frozenset({"Activity Buffer Request", "Buffer Flush", "Instrumentation", "Resource"})


class LoopTracer:
    """Context that traces one stretch of every site loop run inside it.

    ``busy_s``, ``window_s``: device-busy and host-clock seconds over the
    ``sites`` traced loop sites, the latter less ``profiler_s``, the device's idle seconds
    while the host was in the profiler's own work; ``kernels``:
    {name: [launches, seconds]} of device events; ``gaps``: the longest
    idle gaps, [(what the host was doing, seconds)], the profiler's left
    out."""

    def __init__(self, start_site, sites, stretches=1, stride=0, keep_gaps=10):
        self.start_site, self.sites, self.keep_gaps = int(start_site), int(sites), keep_gaps
        self.stretches, self.stride = int(stretches), int(stride)
        if self.stretches > 1 and self.stride < self.sites:
            raise ValueError(f"stretches of {self.sites} sites need a stride of as many, got {self.stride}")
        self.busy_s = self.window_s = self.profiler_s = 0.0
        self.traced_sites = 0
        self.kernels = defaultdict(lambda: [0, 0.0])
        self.gaps = []
        self._pending = []
        self._orig = None

    def __enter__(self):
        from hygeia_tpu_torch.ops import site_graphs

        self._cls = site_graphs.SiteLoop
        self._orig = orig = self._cls.run
        tracer = self

        def run(loop, step, n, kind="site"):
            n = int(n)
            if not loop.graphed:
                return orig(loop, step, n, kind)
            K = loop.K
            head = 1 if kind not in loop.warm else 0
            b = K * max(1, tracer.sites // K)
            done = 0
            for j in range(tracer.stretches):
                a = head + K * max(1, (tracer.start_site + j * tracer.stride - head) // K)
                if a + b + K > n:
                    break
                orig(loop, step, a - done, kind)
                tracer._traced(lambda: orig(loop, step, b, kind), loop.device)
                tracer.traced_sites += b
                done = a + b
            orig(loop, step, n - done, kind)

        self._cls.run = run
        return self

    def __exit__(self, *exc):
        self._cls.run = self._orig
        return False

    def _traced(self, fn, device):
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        torch.cuda.synchronize(device)
        prof.start()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        prof.stop()
        self.window_s += t1 - t0
        self._pending.append(prof)  # reduced once the window has closed

    @staticmethod
    def prime(device):
        """Start and stop the profiler once on a trivial op: the first start
        initialises CUPTI for seconds, which belongs to set-up."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize(device)

    def _reduce(self, prof):
        """Fold one stretch's events in: the profiler's raw events, in ns,
        without building its Python event tree."""
        dev, host, overhead = [], [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns() * 1e-3
            iv = (start, start + e.duration_ns() * 1e-3)  # us
            if e.device_type() == cuda:
                dev.append(iv)
                k = self.kernels[short_name(e.name())]
                k[0] += 1
                k[1] += (iv[1] - iv[0]) * 1e-6
            elif e.name() in PROFILER_OVERHEAD:
                overhead.append(iv)
            else:
                host.append((iv[0], iv[1], e.name()))
        dev.sort()
        merged = []
        for s, t in dev:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        self.busy_s += sum(t - s for s, t in merged) * 1e-6
        idle = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
        stalled = _overlap(idle, _union(overhead)) * 1e-6
        self.profiler_s += stalled
        self.window_s -= stalled
        host.sort()
        over = _union(overhead)
        gaps = sorted(((t - s, s, t) for s, t in idle if not _overlap([(s, t)], over)),
                      reverse=True)[: self.keep_gaps]
        for width, s, t in gaps:
            self.gaps.append((_host_activity(host, (s + t) / 2), width * 1e-6))
        self.gaps = sorted(self.gaps, key=lambda g: -g[1])[: self.keep_gaps]

    def summary(self):
        for prof in self._pending:
            self._reduce(prof)
        self._pending = []
        return {"busy_s": self.busy_s, "window_s": self.window_s, "profiler_s": self.profiler_s,
                "sites": self.traced_sites,
                "kernels": {k: tuple(v) for k, v in self.kernels.items()}, "gaps": list(self.gaps)}


def short_name(name, width=120):
    """A kernel's name without its argument list, the nested template
    arguments kept only as the functors they name: "elementwise_kernel
    [where_kernel_impl]" for PyTorch's elementwise kernel of ``where``."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth, base, inner = 0, [], []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0 and ch == "(":
            break
        elif depth == 0:
            base.append(ch)
    tags = re.findall(r"(\w+_kernel_impl|CUDAFunctor_\w+|\w+Functor\w*|\w+_functor\w*|\w+Op\b)", name)
    for t in tags:
        if t not in inner and not t.startswith("gpu_kernel_impl"):
            inner.append(t)
    base = "".join(base).split("::")[-1].strip()
    return (base + (f"[{','.join(inner[:3])}]" if inner else ""))[:width]


def _union(intervals):
    """Sorted disjoint [start, end] covering the given intervals."""
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _overlap(a, b):
    """Length of the overlap of interval lists ``a`` (disjoint) and ``b``
    (sorted, disjoint)."""
    total = 0.0
    for s, t in a:
        for u, v in b:
            if u >= t:
                break
            total += max(0.0, min(t, v) - max(s, u))
    return total


def _host_activity(host, at):
    """The innermost host event running at time ``at`` (the latest to start
    among those that cover it), or a note that none was traced."""
    best = None
    for s, t, name in host:
        if s > at:
            break
        if t >= at:
            best = name
    return best or "host: no traced op"
