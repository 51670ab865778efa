"""The port's spans and counters: what its coarse phases took, kept in memory.

A span names a stretch of host time (the INFER runner's phases, a site
loop's run, a graph capture); a counter adds up a number (sites and graph
nodes replayed). Spans sit only around coarse work, a few tens a call,
never inside a site step, whose host code runs once, at capture.

Off is the default. While off, ``span`` returns one shared null context
after a flag check, and ``count`` returns at once. Whoever reads the
records calls ``enable()``, runs the work and calls ``drain()``, which
returns what was recorded and clears it; ``disable()`` stops recording.

Each span records its name, its start and end on the monotonic clock
(``time.perf_counter_ns``), its own id, its parent's id and the id of the
root span it descends from (the call: every span of one request shares
it), with its attributes. ``profiler_ns`` maps a stamp onto the clock of
``torch.profiler``'s host events (epoch nanoseconds: kineto converts its
clock to Unix time) by the offset taken at ``enable()``.

Whenever a ``torch.profiler`` is recording, on or off, a span also opens a
profiler range of its name on the host's timeline, so the spans show in a
trace and name what the host was doing. The range is a plain host op
(``cpu_op``), not a ``record_function`` user annotation: the profiler
mirrors a user annotation onto the device's timeline as one interval over
all the kernels it launched, which a reading of the device's busy time
would count as device work. A span made with ``sync=device`` waits for the
device's queued work at its end while the recorder is on, so that it
measures the work and not its enqueue; while off it never waits.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field

import torch

_NULL = contextlib.nullcontext()
_on = False
_offset_ns = 0
_spans = []
_counters = {}
_ids = itertools.count(1)
_local = threading.local()


@dataclass(frozen=True)
class Span:
    """One recorded span; times in ns on ``time.perf_counter_ns``'s clock."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    call: int
    attrs: dict = field(default_factory=dict)

    @property
    def seconds(self):
        return (self.end_ns - self.start_ns) * 1e-9


def _stack():
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _host_range(name):
    """An entered profiler range of ``name`` on the host's timeline."""
    rf = torch._C._profiler._RecordFunctionFast(name)
    rf.__enter__()
    return rf


class _Open:
    """A span being recorded (and, under a running profiler, its range)."""

    __slots__ = ("name", "sync", "attrs", "id", "parent", "call", "start_ns", "_range")

    def __init__(self, name, sync, attrs):
        self.name, self.sync, self.attrs = name, sync, attrs

    def __enter__(self):
        st = _stack()
        up = st[-1] if st else None
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.call = self.id if up is None else up.call
        st.append(self)
        self._range = _host_range(self.name) if torch.autograd._profiler_enabled() else None
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, *exc):
        try:
            if exc_type is None and self.sync is not None and self.sync.type == "cuda":
                torch.cuda.synchronize(self.sync)
            end = time.perf_counter_ns()
            _spans.append(Span(self.name, self.start_ns, end, self.id, self.parent, self.call, self.attrs))
        finally:
            _stack().pop()
            if self._range is not None:
                self._range.__exit__(exc_type, *exc)
        return False


def span(name, sync=None, **attrs):
    """A context timing ``name`` while the recorder is on (``attrs`` kept
    with it); under a running profiler also a host range of that name.
    ``sync``: a device whose queued work the span waits for at its end,
    while the recorder is on."""
    if _on:
        return _Open(name, None if sync is None else torch.device(sync), attrs)
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NULL


def annotate(**attrs):
    """Add ``attrs`` to the innermost open span, while the recorder is on."""
    if _on:
        st = _stack()
        if st:
            st[-1].attrs.update(attrs)


def count(name, n=1):
    """Add ``n`` to counter ``name``, while the recorder is on."""
    if _on:
        _counters[name] = _counters.get(name, 0) + n


def recording():
    return _on


def enable():
    """Start recording; take the offset of the profiler's clock."""
    global _on, _offset_ns
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    _on = True


def disable():
    global _on
    _on = False


def drain():
    """(spans in the order they ended, {counter: total}) recorded since the
    last drain; both are cleared."""
    spans, counters = list(_spans), dict(_counters)
    _spans.clear()
    _counters.clear()
    return spans, counters


def profiler_ns(t_ns):
    """A ``time.perf_counter_ns`` stamp on ``torch.profiler``'s host clock
    (epoch ns), by the offset taken at the last ``enable()``."""
    return t_ns + _offset_ns
