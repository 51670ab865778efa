"""On the card, at the cell's own size: the control, the float64
reference computed in bfloat16 and put in the program's place, comes out
not correct on three seeds, while the program's own run of the same call
is correct; and each planted fault of the timed path comes out not
correct, read over a window of the cell's own length where its number is
a statistic. Skips where there is no CUDA card. Run on the card with

    python -m pytest perfbench/tests/test_perfbench_card.py -m cuda -s

which prints each seed's readings: the program's, the control's and the
faults'."""

from __future__ import annotations

import json
import time

import pytest
import torch

from perfbench import harness
from perfbench.tests import faults, tiny

SEEDS = (2_147_483_659, 3_000_000_019, 4_000_000_007)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's size runs only there")


def _run(seed, seconds, after_window=None):
    return harness.run_cell(bench=tiny.bench(), cell_name=tiny.CELL, seed=seed, seconds=seconds, trace=False,
                            t_start=time.perf_counter(), device="cuda", after_window=after_window)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_at_the_cells_size(seed):
    _needs_card()
    readings = {}
    result, checks = _run(seed, 1e-6, lambda drv: readings.update(drv.control(torch.bfloat16)))
    limits = {c["name"]: c["limit"] for c in checks}
    print(json.dumps({"seed": seed, "program": {c["name"]: c["value"] for c in checks},
                      "control": readings, "limits": limits}))
    assert result["correct"], checks
    assert any(readings[k] > limits[k] for k in limits), readings


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_fails_at_the_cells_size(monkeypatch, fault, seed):
    _needs_card()
    plant, number = faults.FAULTS[fault]
    plant(monkeypatch)
    seconds = tiny.bench()["run_seconds"] if number == "backward_pit_ks" else 1e-6
    result, checks = _run(seed, seconds)
    read = {c["name"]: c for c in checks}
    print(json.dumps({"seed": seed, "fault": fault, "calls": result["attempted"],
                      "readings": {k: c["value"] for k, c in read.items()}}))
    assert result["correct"] is False
    assert read[number]["value"] > read[number]["limit"]
