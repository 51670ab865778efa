"""BENCHMARK.json and the files it names: every configuration, cell,
traffic and metric loads by name, and a cell, configuration, traffic and
metric added as new files under temporary names runs with no edit."""

from __future__ import annotations

import json
import re
import shutil
import uuid

import pytest

from perfbench import harness, inputs, peaks
from perfbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_and_names():
    b = tiny.bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and b["command"][1] == "perfbench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    metrics = b["end_to_end"] + b["per_layer"]
    names += [m["name"] for m in metrics] + [w["traffic"] for w in b["workloads"]]
    assert all(NAME.match(n) for n in names), names
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
               for m in b["end_to_end"])
    assert all(m["moves"] in e2e and m["layer"] for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in tiny.bench()["workloads"]])
def test_cell_files_load_by_name(cell):
    b = tiny.bench()
    spec, config, traffic = harness.cell_spec(b, cell)
    assert (harness.BENCH_DIR / "drivers" / f"{spec['driver']}.py").exists()
    assert set(spec["limits"]) and all(v >= 0 for v in spec["limits"].values())
    conf = {c["name"]: c for c in b["configs"]}[spec["config"]]
    assert conf["file"] == f"perfbench/configs/{spec['config']}.json"
    assert set(conf["reduced"]) == set(config["reduced"]) and set(config["reduced"]) <= set(config["published"])
    assert callable(getattr(inputs, traffic["generator"]))


@pytest.mark.parametrize("name", [m["name"] for m in tiny.bench()["end_to_end"] + tiny.bench()["per_layer"]])
def test_metric_reader_loads_by_name(name):
    mod = harness.reader(name)
    empty = harness.Run({}, {}, {})
    assert callable(mod.read)
    assert mod.read(empty) is None  # nothing to read gives no number, never 0


@pytest.mark.parametrize("units,n,m,want", [(1, 2400, 50, 10_409), (2, 2400, 50, 20_818), (1, 250, 244, 4_913)])
def test_k1_bytes_hand_worked(units, n, m, want):
    # 4 N bytes of weights, 4 of the systematic uniform, 4 M of multinomial
    # uniforms in; 4 M parents, 4 M weights, 4 M top indices, 4 of log c, 1
    # flag out.
    assert peaks.k1_bytes(units, n, m) == want
    assert peaks.k1_bound_s(units, n, m) == pytest.approx(want / 3.35e12)


def test_cell_config_traffic_metric_added_as_files():
    """A copy of the cell under new names, with a new metric, runs through
    the harness: additions are files and BENCHMARK.json entries only."""
    tag = "tmp_" + uuid.uuid4().hex[:8]
    d = harness.BENCH_DIR
    made = [d / "configs" / f"{tag}.json", d / "traffic" / f"{tag}.json",
            d / "workloads" / f"{tag}.cell.json", d / "metrics" / f"{tag}.calls.py"]
    b = tiny.bench()
    try:
        shutil.copy(d / "configs" / "two_group_nf_defaults.json", made[0])
        shutil.copy(d / "traffic" / "seg_interior_2seeds.json", made[1])
        shutil.copy(d / "workloads" / f"{tiny.CELL}.json", made[2])
        made[3].write_text("def read(run):\n    return float(len(run.calls)) if run.calls else None\n")
        b["configs"].append({**b["configs"][0], "name": tag, "file": f"perfbench/configs/{tag}.json"})
        b["workloads"].append({"name": f"{tag}.cell", "config": tag, "traffic": tag, "chips": 1, "why": "test"})
        b["per_layer"].append({"name": f"{tag}.calls", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "INFER runner",
                               "moves": "infer_unit_sites_per_s", "workloads": [f"{tag}.cell"]})
        result, _ = tiny.run(cell=f"{tag}.cell", bench_doc=b, trace=True)
        assert result["metrics"][f"{tag}.calls"]["value"] == 1.0
    finally:
        for p in made:
            p.unlink(missing_ok=True)


def test_loop_tracer_splits_a_loop_into_whole_graphs(monkeypatch):
    """The traced stretches cut a loop's run into parts that replay the
    same graphs in the same order: the first part holds the eager first
    site and whole graphs, every later part but the last whole graphs,
    and the stretches fall where the cell file puts them."""
    from types import SimpleNamespace

    from hygeia_tpu_torch.ops import site_graphs
    from perfbench import loop_trace

    parts = []
    monkeypatch.setattr(site_graphs.SiteLoop, "run", lambda loop, step, n, kind="site": parts.append(n))
    tracer = loop_trace.LoopTracer(start_site=1025, sites=512, stretches=4, stride=2048)
    traced = []
    monkeypatch.setattr(tracer, "_traced", lambda fn, device: (traced.append(len(parts)), fn()))
    loop = SimpleNamespace(graphed=True, K=8, warm=set(), device=None)
    with tracer:
        site_graphs.SiteLoop.run(loop, None, 10_999)
    assert sum(parts) == 10_999 and len(traced) == 4 and tracer.traced_sites == 4 * 512
    assert parts[0] % 8 == 1 and all(p % 8 == 0 for p in parts[1:-1])
    starts = [sum(parts[:i]) for i in traced]
    assert starts == [1025, 3073, 5121, 7169] and all(parts[i] == 512 for i in traced)


def test_profiler_stalls_come_off_the_idle_time():
    from perfbench import loop_trace

    over = loop_trace._union([(5.0, 7.0), (6.0, 9.0), (20.0, 21.0)])
    assert over == [[5.0, 9.0], [20.0, 21.0]]
    assert loop_trace._overlap([(0.0, 6.0), (8.0, 30.0)], over) == pytest.approx(1.0 + 1.0 + 1.0)
