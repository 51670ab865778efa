"""The θ cell, theta.chrom: its files load by name; on the CPU at a small
size a run prints the contract's last line and comes out correct, a traced
run reports the program's spans, and the control (the reference in
bfloat16 in the program's place) and each planted fault
(``faults_theta.py``) come out not correct; the reference loads nothing of
the program and a run loads no JAX. On the card, at the cell's own size,
the control and the faults fail and the program's run of the same call
passes:

    python -m pytest perfbench/tests/test_perfbench_theta.py -m cuda -s

prints each seed's readings."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness
from perfbench.tests import faults_theta

CELL = "theta.chrom"
TINY = {"traffic": {"chromosome_sites": 2000, "sites_per_call": 1000, "warmup_sites": 100},
        "cell": {"check": {"steady_sites": 12, "update_sites": 3}}}
SEEDS = (2_147_483_659, 3_000_000_019, 4_000_000_007)


def _bench():
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


def _run(seed, device="cpu", trace=False, after_window=None, overrides=TINY, seconds=1e-6):
    return harness.run_cell(bench=_bench(), cell_name=CELL, seed=seed, seconds=seconds, trace=trace,
                            t_start=time.perf_counter(), device=device, overrides=overrides,
                            after_window=after_window)


def test_theta_files_load_by_name_and_fit_the_engine():
    b = _bench()
    cell, config, traffic = harness.cell_spec(b, CELL)
    assert cell["driver"] == "theta_chrom" and cell["chips"] == 1
    assert config["num_particles"] == 250 and config["d_max"] == 4096 and config["minimum_duration"] == 3
    assert traffic["chromosome_sites"] % traffic["sites_per_call"] == 0 and traffic["units_per_call"] == 1
    # A traced stretch lies inside one steady run of 199 sites, whole graphs
    # of 8 after the run's first site, and no more than 4,096 sites a call.
    tr, every = cell["trace"], config["n_steps_without_parameter_update"]
    assert tr["start_site"] + tr["sites"] + 8 <= every - 1 and tr["stretches"] == 1
    assert tr["sites"] * (traffic["sites_per_call"] // every) <= 4096
    layer = {m["name"]: m for m in b["per_layer"]}
    for name in ("engine.ms_per_site.theta", "engine.update_ms_per_site.theta", "runner.host_s_per_call.theta",
                 "k1.roofline_pct.theta", "device.busy_ms_per_site.theta", "device.peak_mem_gib.theta"):
        assert layer[name]["workloads"] == [CELL] and layer[name]["moves"] == "infer_unit_sites_per_s"
    assert [m["name"] for m in harness.metrics_of(b, CELL, "end_to_end")] == ["infer_unit_sites_per_s", "setup_s"]


def test_theta_dry_run_prints_the_last_line_and_is_correct():
    result, checks = _run(2**31 + 12345)
    line = json.loads(harness.result_line(result, checks, {"name": None, "power_limit_w": None}))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"infer_unit_sites_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["checks"]) == set(harness.cell_spec(_bench(), CELL)[0]["limits"])


def test_theta_traced_run_reports_the_program_spans():
    result, _ = _run(7, trace=True)
    # On the CPU the loops run eagerly and nothing is traced: the device
    # metrics are left out, the program's spans are read.
    got = result["metrics"]
    assert set(got) == {"engine.ms_per_site.theta", "engine.update_ms_per_site.theta",
                        "runner.host_s_per_call.theta"}
    assert all(v["value"] > 0 for v in got.values())


def test_theta_control_is_not_correct():
    readings = {}
    _, checks = _run(3, after_window=lambda drv: readings.update(drv.control(torch.bfloat16)))
    limits = {c["name"]: c["limit"] for c in checks}
    assert all(c["value"] <= c["limit"] for c in checks)
    failed = {k for k in limits if readings[k] > limits[k]}
    assert {"theta_gap", "logz_gap", "regime_gap", "params_gap"} <= failed, readings


@pytest.mark.parametrize("fault", sorted(faults_theta.FAULTS))
def test_theta_fault_is_not_correct(monkeypatch, fault):
    plant, number = faults_theta.FAULTS[fault]
    plant(monkeypatch)
    result, checks = _run(12)
    read = {c["name"]: c for c in checks}[number]
    assert result["correct"] is False and read["value"] > read["limit"]


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps(sorted(sys.modules)))"],
                         capture_output=True, text=True, cwd=harness.ROOT, check=True, timeout=600)
    return {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}


def test_theta_reference_loads_no_jax_and_nothing_of_the_program():
    tops = _modules_after("import perfbench.reference.single_group")
    assert not tops & {"jax", "jaxlib", "flax", "hygeia_tpu", "hygeia_tpu_torch"}


def test_a_theta_run_loads_no_jax():
    code = ("import time\nfrom perfbench import harness\nfrom perfbench.tests import test_perfbench_theta as t\n"
            "t._run(9)")
    tops = _modules_after(code)
    assert "hygeia_tpu_torch" in tops and not tops & set(harness.FORBIDDEN)


# ---- on the card, at the cell's size ---------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's size runs only there")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_theta_control_fails_at_the_cells_size(seed):
    _needs_card()
    readings = {}
    result, checks = _run(seed, "cuda", after_window=lambda drv: readings.update(drv.control(torch.bfloat16)),
                          overrides=None)
    limits = {c["name"]: c["limit"] for c in checks}
    print(json.dumps({"seed": seed, "program": {c["name"]: c["value"] for c in checks},
                      "control": readings, "limits": limits}))
    assert result["correct"], checks
    assert any(readings[k] > limits[k] for k in limits), readings


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", sorted(faults_theta.FAULTS))
def test_theta_fault_fails_at_the_cells_size(monkeypatch, fault, seed):
    _needs_card()
    plant, number = faults_theta.FAULTS[fault]
    plant(monkeypatch)
    result, checks = _run(seed, "cuda", overrides=None)
    read = {c["name"]: c for c in checks}
    print(json.dumps({"seed": seed, "fault": fault, "readings": {k: c["value"] for k, c in read.items()}}))
    assert result["correct"] is False
    assert read[number]["value"] > read[number]["limit"]
