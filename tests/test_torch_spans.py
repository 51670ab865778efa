"""The port's span and counter recorder (hygeia_tpu_torch/utils/spans.py)
on the CPU, and the spans of the INFER runner and of the site loops.

Off (the default) a span records nothing, and opens a profiler range
only while a ``torch.profiler`` is recording, on the host's timeline only
(a ``cpu_op``, which the profiler does not mirror onto the device's
timeline as it does a user annotation); on, spans nest under their
parents and share their root's call id, counters add, ``drain()`` clears,
and a span's start maps onto the profiler's clock. ``infer_segment`` with
the recorder on writes the files it writes with it off, and its phases
cover its wall; a site loop on the CPU records its run and no capture.
"""

import gc
import gzip
import os
import time

import numpy as np
import pytest
import torch

from hygeia_tpu_torch.ops.site_graphs import SiteLoop
from hygeia_tpu_torch.two_group.runner import infer_segment
from hygeia_tpu_torch.utils import io as hio
from hygeia_tpu_torch.utils import spans

torch.set_num_threads(1)

CALL_CHILDREN = ("infer.read", "infer.write", "infer.tables", "infer.filter", "infer.backward", "infer.fetch")


@pytest.fixture
def recorder():
    """The recorder on, emptied before and after; off again at the end."""
    spans.drain()
    spans.enable()
    try:
        yield spans
    finally:
        spans.disable()
        spans.drain()


@pytest.mark.parametrize("profiled", [False, True])
def test_off_records_nothing_and_opens_a_range_only_under_a_profiler(monkeypatch, profiled):
    from torch.profiler import ProfilerActivity, profile

    spans.drain()
    assert not spans.recording()
    if not profiled:
        def refuse(name):
            raise AssertionError(f"a profiler range was opened for {name!r}")

        monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
        monkeypatch.setattr(torch.profiler, "record_function", refuse)
        assert spans.span("a") is spans.span("b", sync="cpu", x=1)  # one shared null context
        with spans.span("a", x=1):
            spans.annotate(y=2)
            spans.count("n", 3)
    else:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with spans.span("off.range"):
                torch.ones(4).add_(1)
        (e,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "off.range"]
        assert not e.is_user_annotation()
    assert spans.drain() == ([], {})


def test_spans_nest_carry_parent_ids_and_share_the_root_call_id(recorder):
    with recorder.span("a", x=1):
        with recorder.span("b"):
            with recorder.span("c"):
                pass
            recorder.annotate(z=3)
        with recorder.span("d"):
            pass
    with recorder.span("e"):
        pass
    got, _ = recorder.drain()
    by = {s.name: s for s in got}
    assert [s.name for s in got] == ["c", "b", "d", "a", "e"]  # the order they ended
    a, b, c, d, e = (by[k] for k in "abcde")
    assert a.parent is None and b.parent == a.id and c.parent == b.id and d.parent == a.id
    assert a.call == b.call == c.call == d.call == a.id and e.call == e.id != a.id and e.parent is None
    assert a.attrs == {"x": 1} and b.attrs == {"z": 3}
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= d.start_ns <= d.end_ns <= a.end_ns
    assert all(s.seconds >= 0 for s in got)


def test_a_span_records_and_closes_when_its_body_raises(recorder):
    with pytest.raises(ValueError):
        with recorder.span("outer"):
            with recorder.span("inner"):
                raise ValueError("x")
    with recorder.span("after"):
        pass
    got, _ = recorder.drain()
    by = {s.name: s for s in got}
    assert set(by) == {"outer", "inner", "after"} and by["after"].parent is None


def test_counters_add(recorder):
    recorder.count("sites", 8)
    recorder.count("sites", 3)
    recorder.count("nodes")
    assert recorder.drain()[1] == {"sites": 11, "nodes": 1}


def test_drain_clears(recorder):
    with recorder.span("a"):
        recorder.count("n", 2)
    first = recorder.drain()
    assert [s.name for s in first[0]] == ["a"] and first[1] == {"n": 2}
    assert recorder.drain() == ([], {})
    recorder.disable()
    with recorder.span("b"):
        recorder.count("n")
    assert recorder.drain() == ([], {})


@pytest.mark.parametrize("on", [False, True])
def test_a_span_waits_for_its_device_only_while_on(monkeypatch, on):
    waits = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: waits.append(device))
    spans.drain()
    if on:
        spans.enable()
    try:
        with spans.span("queued", sync=torch.device("cuda", 0)):
            pass
        with spans.span("host", sync=torch.device("cpu")):
            pass
    finally:
        spans.disable()
        spans.drain()
    assert waits == ([torch.device("cuda", 0)] if on else [])


def test_a_span_starts_on_the_profiler_clock_with_its_range(recorder):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        time.sleep(0.01)
        with recorder.span("clock.check"):
            torch.ones(8).mul_(2)
        time.sleep(0.01)
    (s,), _ = recorder.drain()
    (e,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "clock.check"]
    assert not e.is_user_annotation()
    assert abs(recorder.profiler_ns(s.start_ns) - e.start_ns()) < 1_000_000
    assert abs(recorder.profiler_ns(s.end_ns) - (e.start_ns() + e.duration_ns())) < 1_000_000


def test_site_loop_on_the_cpu_records_its_run_and_no_capture(recorder):
    calls = []
    with SiteLoop("cpu", 8) as loop:
        loop.run(lambda: calls.append(1), 19, kind="steady")
        loop.run(lambda: calls.append(2), 0)
    got, counters = recorder.drain()
    assert calls == [1] * 19
    assert [(s.name, s.attrs) for s in got] == [("site_loop.run", {"kind": "steady", "sites": 19})]
    assert counters == {}


# ---- infer_segment with the recorder on ------------------------------------------

def _dataset(root, T=70):
    rng = np.random.default_rng(3)
    data, sg = root / "data", root / "sg"
    n = rng.poisson(15, size=(T, 2))
    hio.write_count_matrix(data / "positions_c.txt.gz", np.arange(1, T + 1) * 10)
    for g, p in (("control", 0.8), ("case", 0.3)):
        hio.write_count_matrix(data / f"n_total_reads_{g}_c.txt.gz", n)
        hio.write_count_matrix(data / f"n_methylated_reads_{g}_c.txt.gz", rng.binomial(n, p))
    hio.write_theta(sg / "theta_c.csv.gz", rng.normal(size=36))
    return dict(data_dir=str(data), single_group_dir=str(sg), chrom="c", device="cpu", batch=1,
                segment_size=30, buffer_size=5, seed=[4, 5], num_resampled_particles=(4,),
                num_samples_backward=8)


@pytest.fixture(scope="module")
def recorded_call(tmp_path_factory):
    """One infer_segment call with the recorder off and the same call with
    it on: (output directories, spans and counters of the second). The
    collector is held off during the second: a pause between two phases
    is the interpreter's time, not the runner's."""
    root = tmp_path_factory.mktemp("spans")
    kw = _dataset(root)
    spans.drain()
    a = infer_segment(results_dir=str(root / "off"), **kw)
    gc.collect()
    gc.disable()
    spans.enable()
    try:
        b = infer_segment(results_dir=str(root / "on"), **kw)
    finally:
        spans.disable()
        gc.enable()
    got, counters = spans.drain()
    assert a == b
    return root / "off" / "chrom_c_1", root / "on" / "chrom_c_1", got, counters


def test_infer_segment_with_the_recorder_on_writes_the_same_files(recorded_call):
    off, on, _, _ = recorded_call
    files = sorted(os.listdir(off))
    assert files == sorted(os.listdir(on)) and any(f.endswith(".npz") for f in files)
    for name in files:
        if name.endswith(".npz"):
            a, b = np.load(off / name)["arr_0"], np.load(on / name)["arr_0"]
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        elif name.endswith(".gz"):  # the gzip header holds a time stamp
            assert gzip.decompress((off / name).read_bytes()) == gzip.decompress((on / name).read_bytes())
        elif not name.startswith("optimal_time"):
            assert (off / name).read_bytes() == (on / name).read_bytes(), name


def test_infer_call_phases_cover_its_wall(recorded_call):
    *_, got, _ = recorded_call
    (call,) = [s for s in got if s.name == "infer.call"]
    assert call.attrs == {"chrom": "c", "batch": 1, "units": 2, "sites": 40}
    children = [s for s in got if s.parent == call.id]
    assert all(s.call == call.id for s in got)
    assert {s.name for s in children} == set(CALL_CHILDREN)
    order = [s.name for s in sorted(children, key=lambda s: s.start_ns)]
    assert order[:3] == ["infer.read", "infer.write", "infer.tables"]
    assert order[3:6] == ["infer.filter", "infer.backward", "infer.fetch"] and order[6:] == ["infer.write"] * 2
    covered = sum(s.end_ns - s.start_ns for s in children)
    assert covered >= 0.9 * (call.end_ns - call.start_ns), (covered, call.end_ns - call.start_ns)
    # The site loops (filter and backward, eager on the CPU) inside their phases.
    loops = [s for s in got if s.name == "site_loop.run"]
    assert len(loops) == 2 and all(s.attrs["sites"] == 39 for s in loops)
    assert {by.name for s in loops for by in got if by.id == s.parent} == {"infer.filter", "infer.backward"}
