"""Site loops as replayed CUDA graphs.

The JAX package runs each site loop (the two-group filter, the backward
pass, the single-group engine) as one compiled ``lax.scan``. This is the
port's counterpart: on a CUDA device a loop captures K consecutive calls
of its site step into a ``torch.cuda.CUDAGraph`` once and then replays the
graph, K sites a replay (K plays the role of JAX's ``unroll``). On the CPU,
and on the card with K = 0 (a route kept only to compare the two), the
same step is called eagerly, one site a call.

A step is a function of no arguments that a replay can repeat:
- it reads its site from a device index tensor that it advances itself
  (``add_`` / ``sub_``), never from a Python int;
- its carry lives in tensors made before the loop, which it overwrites in
  place (``copy_``, ``index_copy_``); rebinding a name would leave the next
  replay reading the capture's memory;
- it never waits for the device (no ``.item()``, no boolean-mask
  indexing, no ``nonzero``) and copies nothing from the host;
- its draws come from the ``torch.Generator``s given to the loop, which
  are registered with every graph, so a replay advances each generator as
  the eager draws would: a graphed run draws the eager run's numbers.

The first site of each kind of step runs eagerly before that kind is
captured (the resampler's wrapper opts in to shared memory at its first
launch, cuBLAS makes its handle). Sites that do not fill a last group of K
replay a one-site graph of the same step. Every graph of a loop shares one
memory pool; the loop's graphs are freed when it ends. A failed capture
or replay raises; nothing falls back to the eager route.

The kernels' launch counts count executions: each kernel's wrapper
(``build.KERNELS``: K1, K2, K3, K4) counts the launches a capture
records apart (``KERNEL.captured``), and each replay adds its graph's
counts to their ``KERNEL.launches``.

Spans (utils/spans.py): each ``run`` is a ``site_loop.run`` span (kind,
sites), with a ``site_loop.warm`` span for a kind's eager first site and a
``site_loop.capture`` span for each graph made (kind, sites, nodes); once a
``run`` it adds the sites it replayed and the graph nodes they executed to
the counters ``site_loop.sites_replayed`` and ``site_loop.nodes_replayed``,
for the graphs captured while the recorder was on: their nodes are counted
at the end of the capture, from the graph being captured, so every graph
is made the same way whether the recorder is on or off. While the recorder
is on, the spans wait for the device at their ends and a capture waits for
it before it starts, so each measures its own work.
"""

from __future__ import annotations

import ctypes

import torch

from hygeia_tpu_torch.ops.build import KERNELS
from hygeia_tpu_torch.utils import spans

# Sites a graph: JAX's filter unroll (hygeia_tpu/two_group/filter.py).
SITES_PER_GRAPH = 8
# One side stream a device for every loop: cuBLAS keeps a workspace for
# each stream it runs on (32 MiB on an H100), so a new stream a loop would
# hold one more workspace a loop.
_STREAMS = {}


def _sync(device):
    """Wait for ``device``'s work; nothing on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _loop_stream(device):
    if device.index not in _STREAMS:
        _STREAMS[device.index] = torch.cuda.Stream(device)
    return _STREAMS[device.index]


_LIBCUDA = {}


def _libcuda(name, *argtypes):
    if name not in _LIBCUDA:
        fn = getattr(ctypes.CDLL("libcuda.so.1"), name)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        _LIBCUDA[name] = fn
    return _LIBCUDA[name]


def captured_nodes(stream):
    """Nodes of the graph being captured on ``stream`` so far: libcuda's
    ``cuStreamGetCaptureInfo_v2`` for the graph, ``cuGraphGetNodes`` for
    its count."""
    p = ctypes.POINTER
    info = _libcuda("cuStreamGetCaptureInfo_v2", ctypes.c_void_p, p(ctypes.c_int), p(ctypes.c_uint64),
                   p(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p)
    get_nodes = _libcuda("cuGraphGetNodes", ctypes.c_void_p, ctypes.c_void_p, p(ctypes.c_size_t))
    status, graph, n = ctypes.c_int(0), ctypes.c_void_p(), ctypes.c_size_t(0)
    err = info(stream.cuda_stream, ctypes.byref(status), None, ctypes.byref(graph), None, None)
    if err or status.value != 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
        raise RuntimeError(f"cuStreamGetCaptureInfo_v2: CUresult {err}, capture status {status.value}")
    err = get_nodes(graph, None, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes: CUresult {err}")
    return n.value


class SiteLoop:
    """A context for one site loop on ``device``.

    ``run(step, n, kind)`` calls ``step`` n times in effect: eagerly on the
    CPU or with ``sites_per_graph`` 0; on a CUDA device through graphs of
    K and of one site, captured at the first call of their ``kind`` (a
    hashable naming a step whose host-side branches hold for every site it
    is called on). Work between ``run`` calls (eager sites of another kind)
    runs on the loop's stream too. ``generator``: what the steps draw
    from, one ``torch.Generator``, a list of them or None (the default
    generator)."""

    def __init__(self, device, sites_per_graph=SITES_PER_GRAPH, generator=None):
        if int(sites_per_graph) != sites_per_graph or sites_per_graph < 0:
            raise ValueError("sites_per_graph must be an int >= 0 (0: eager on the card), "
                             f"got {sites_per_graph!r}")
        self.device = torch.device(device)
        self.K = int(sites_per_graph)
        self.graphed = self.device.type == "cuda" and self.K > 0
        gens = generator if isinstance(generator, (list, tuple)) else [generator]
        self.generators = [g for g in gens if g is not None]
        self.graphs = {}  # (kind, sites) -> (graph, {kernel: its launches a replay})
        self.nodes = {}  # (kind, sites) -> the graph's nodes, if captured while recording
        self.warm = set()
        self._pool = self._stream = self._ctx = None

    def __enter__(self):
        if self.device.type == "cuda":
            # Capture needs a side stream; the whole loop runs on it.
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self._stream = _loop_stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            self._ctx = torch.cuda.stream(self._stream)
            self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        if self._ctx is not None:
            self._ctx.__exit__(*exc)
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
        self.graphs.clear()  # frees the graphs and their pool
        self.nodes.clear()
        self._pool = self._ctx = None
        return False

    def run(self, step, n, kind="site"):
        n = int(n)
        if n <= 0:
            return
        with spans.span("site_loop.run", sync=self.device if self.graphed else None, kind=kind, sites=n):
            if not self.graphed:
                for _ in range(n):
                    step()
                return
            if kind not in self.warm:
                with spans.span("site_loop.warm", sync=self.device, kind=kind):
                    step()
                self.warm.add(kind)
                n -= 1
            full, rest = divmod(n, self.K)
            for sites, reps in ((self.K, full), (1, rest)):
                if reps:
                    graph, launches = self._graph(step, kind, sites)
                    for _ in range(reps):
                        graph.replay()
                        for kernel, k in launches.items():
                            kernel.launches += k
                    nodes = self.nodes.get((kind, sites))
                    if nodes is not None and spans.recording():
                        spans.count("site_loop.sites_replayed", sites * reps)
                        spans.count("site_loop.nodes_replayed", nodes * reps)

    def _graph(self, step, kind, sites):
        key = (kind, sites)
        if key not in self.graphs:
            if spans.recording():
                torch.cuda.synchronize(self.device)  # the capture's span holds no earlier work
            with spans.span("site_loop.capture", kind=kind, sites=sites):
                graph = torch.cuda.CUDAGraph()
                for g in self.generators:
                    graph.register_generator_state(g)
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                before = {kernel: kernel.captured for kernel in KERNELS}
                with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
                    for _ in range(sites):
                        step()
                    if spans.recording():
                        self.nodes[key] = captured_nodes(self._stream)
                        spans.annotate(nodes=self.nodes[key])
                self.graphs[key] = (graph, {k: k.captured - before.get(k, 0) for k in KERNELS})
        return self.graphs[key]
