"""The harness on the CPU at a small size: a run prints the contract's
last line and comes out correct; the control (the reference in bfloat16 in
the program's place) and the program's faults come out not correct; no
run loads JAX or the JAX package, and the reference loads nothing of the
program."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from perfbench import harness
from perfbench.tests import faults, tiny


def _line(result, checks):
    return json.loads(harness.result_line(result, checks, {"name": None, "power_limit_w": None}))


def test_dry_run_prints_the_last_line_and_is_correct():
    result, checks = tiny.run(seed=2**31 + 12345)
    line = _line(result, checks)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] == 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"infer_unit_sites_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["checks"]) == set(harness.cell_spec(tiny.bench(), tiny.CELL)[0]["limits"])


def test_traced_run_reports_per_layer_metrics_it_can_read():
    result, _ = tiny.run(seed=7, trace=True)
    # On the CPU the loops run eagerly and nothing is traced: the device
    # metrics are left out, the program's spans are read.
    assert set(result["metrics"]) == {"filter.ms_per_site.infer", "backward.ms_per_site.infer",
                                      "runner.host_s_per_call.infer"}


def test_control_is_not_correct():
    readings = {}

    def control(drv):
        readings.update(drv.control(torch.bfloat16))

    _, checks = tiny.run(seed=3, after_window=control)
    limits = {c["name"]: c["limit"] for c in checks}
    assert all(c["value"] <= c["limit"] for c in checks)
    failed = [k for k in limits if readings[k] > limits[k]]
    assert {"weights_tv", "shift_gap", "emission_gap", "functionals_gap"} <= set(failed), readings


def _patched(monkeypatch, module, name, wrap):
    monkeypatch.setattr(module, name, wrap(getattr(module, name)))


def test_fault_step_returns_its_state_unchanged(monkeypatch):
    from hygeia_tpu_torch.two_group import filter as flt

    _patched(monkeypatch, flt, "_one_step", lambda f: lambda params, rc, rk, lw, parts, *a, **k: (lw.clone(), parts.clone()))
    result, checks = tiny.run(seed=4)
    assert result["correct"] is False
    assert {c["name"]: c["value"] for c in checks}["states"] > 0


def test_fault_half_the_batch_left_out(monkeypatch):
    from hygeia_tpu_torch.two_group import runner

    _patched(monkeypatch, runner, "smoothing_functionals",
             lambda f: lambda traj, R: f(traj[:, :, : traj.shape[2] // 2], R))
    result, checks = tiny.run(seed=5)
    assert result["correct"] is False
    assert {c["name"]: c["value"] for c in checks}["functionals_gap"] > 1e-3


def test_fault_answer_altered_where_produced(monkeypatch):
    from hygeia_tpu_torch.two_group import runner

    def wrap(f):
        def write(path, N, s, traj, split, regime, ret):
            traj = traj.copy()
            traj[ret.start + 5, 0, 2] = (traj[ret.start + 5, 0, 2] + 1) % 6  # one control regime
            return f(path, N, s, traj, split, regime, ret)
        return write

    _patched(monkeypatch, runner, "_write_unit_outputs", wrap)
    result, checks = tiny.run(seed=6)
    assert result["correct"] is False
    assert {c["name"]: c["value"] for c in checks}["paths"] > 0


def test_fault_log_z_altered_where_produced(monkeypatch):
    from hygeia_tpu_torch.two_group import runner

    def wrap(f):
        def write(path, flags, s, log_norm, times, times_backward):
            return f(path, flags, s, {n: v + 1.0 for n, v in log_norm.items()}, times, times_backward)
        return write

    _patched(monkeypatch, runner, "_write_seed_files", wrap)
    result, checks = tiny.run(seed=8)
    assert result["correct"] is False
    assert {c["name"]: c["value"] for c in checks}["logz_gap"] >= 1.0


@pytest.mark.parametrize("fault", ["k1_keeps_first_m", "k1_keeps_lightest_m"])
def test_fault_k1_keeps_the_wrong_ancestors(monkeypatch, fault):
    plant, number = faults.FAULTS[fault]
    plant(monkeypatch)
    result, checks = tiny.run(seed=12)
    read = {c["name"]: c for c in checks}[number]
    assert result["correct"] is False
    assert read["value"] > read["limit"]


def test_fault_backward_uniform_over_feasible_particles(monkeypatch):
    # The draws' transform reads only kernels with a real choice (near a
    # change point), so this run samples most of its short segment.
    plant, number = faults.FAULTS["backward_uniform_over_feasible"]
    plant(monkeypatch)
    monkeypatch.setitem(tiny.TINY, "cell", {"check": {"sites_per_unit": 300}})
    result, checks = tiny.run(seed=12)
    read = {c["name"]: c for c in checks}[number]
    assert result["correct"] is False
    assert read["value"] > read["limit"]


def test_sound_backward_passes_the_transform_at_the_same_size(monkeypatch):
    monkeypatch.setitem(tiny.TINY, "cell", {"check": {"sites_per_unit": 300}})
    result, checks = tiny.run(seed=12)
    assert result["correct"] is True, checks


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps(sorted(sys.modules)))"],
                         capture_output=True, text=True, cwd=harness.ROOT, check=True, timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_loads_no_jax_and_nothing_of_the_program():
    mods = _modules_after("import perfbench.reference.two_group")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "flax", "hygeia_tpu", "hygeia_tpu_torch"}


def test_a_run_loads_no_jax():
    mods = _modules_after("from perfbench.tests import tiny\ntiny.run(seed=9)")
    tops = {m.split(".")[0] for m in mods}
    assert "hygeia_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", tiny.CELL, "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=harness.ROOT, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""
