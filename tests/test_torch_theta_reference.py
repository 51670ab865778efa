"""The port's single-group engine against the benchmark's plain reference
(perfbench/reference/single_group.py), the θ stage's spans and counters,
and the θ cell's check on the CPU at a small size.

The engine in float64 with injected uniforms follows the reference draw
for draw: both resample in float32 from the same uniforms, so they keep
the same ancestors, and every other number is float64. The θ call with the
span recorder on records the runner's phases and the engine's site
classes, and writes what it writes with the recorder off. The cell's check
reads nothing on the port's own run and catches each planted fault.
"""

import gzip
import os
import time

import numpy as np
import pytest
import torch

from hygeia_tpu_torch.single_group import engine as te
from hygeia_tpu_torch.single_group.model import make_model
from hygeia_tpu_torch.single_group.runner import estimate_parameters_and_regimes
from hygeia_tpu_torch.utils import spans
from perfbench import harness
from perfbench.reference import single_group as ref
from perfbench.tests import faults_theta

torch.set_num_threads(1)

MU = (0.95, 0.05, 0.8, 0.2, 0.5, 0.5)
SIGMA = (0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751)
R, U_MIN, D_MAX = 6, 3, 512


def _inputs(seed, T, N):
    """Seeded counts of regime runs (mean 40 sites), their float64 emission
    table, θ with P's entries N(0, 1) and ω in [0.97, 0.995] (the tables'
    survival stays far above float64's resolution for every sojourn the
    T sites reach), and the uniforms of sites 1..T-1."""
    rng = np.random.default_rng(seed)
    n = rng.poisson(20, (T, 2))
    regime = np.repeat(rng.integers(0, R, T), rng.geometric(1 / 40, T))[:T]
    y = rng.binomial(n, np.array(MU)[regime][:, None])
    a, b = ref.alpha_beta(torch.tensor(MU, dtype=torch.float64), torch.tensor(SIGMA, dtype=torch.float64))
    omega = rng.uniform(0.97, 0.995, R)
    theta = np.concatenate([rng.normal(size=R * (R - 1)), np.log(omega / (1 - omega))])
    u_sys = rng.random((T - 1, 1)).astype(np.float32)
    u_mult = rng.random((T - 1, 1, N - R)).astype(np.float32)
    return ref.emission_table(y, n, a, b), theta, u_sys, u_mult


# seed, T, N, smoothing window, sites an update: the last keeps a 4-entry
# window, so entries spill.
CASES = {"window_128": (4, 400, 30, 128, 50), "window_4_spills": (3, 400, 30, 4, 50),
         "n_60": (11, 300, 60, 128, 40)}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_follows_the_plain_reference_draw_for_draw(case):
    seed, T, N, window, every = CASES[case]
    E, theta, u_sys, u_mult = _inputs(seed, T, N)
    cfg = te.EngineConfig(n_particles_max=N, smoothing_window=window, steps_per_update=every,
                          estimate_regimes=True, estimate_parameters=True)
    model = make_model(MU, SIGMA, U_MIN, [2.0] * R, device="cpu", d_max=D_MAX, dtype=torch.float64)
    got = te.run_online_combined_inference(model, torch.tensor(theta), E, cfg, u_sys=u_sys, u_mult=u_mult,
                                           weight_dtype=torch.float64)
    s = ref.Settings(R, U_MIN, 2.0, D_MAX, N, smoothing_window=window, steps_per_update=every)
    want = ref.run(E, theta, s, torch.from_numpy(u_sys[:, 0]))
    assert int(got.spill_count[0]) == want["spill"]
    if case == "window_4_spills":
        assert want["spill"] > 0
    assert torch.equal(got.regime_valid[0], want["regime_valid"]) and bool(want["regime_valid"].all())
    # The program keeps its regime marginals in float32: half an ulp of 1.
    np.testing.assert_allclose(got.regime_probs[0].double(), want["regime_probs"], rtol=0, atol=6e-8)
    # float64 throughout, the hazard summed from the head (the program) or
    # the tail (the reference): a relative 1e-12 of logZ (~1.5e3 nats).
    np.testing.assert_allclose(float(got.log_normalizing_constant[0]), want["log_z"], rtol=1e-12)
    # θ moves by ADAM steps of ~1e-2 from values of order 1; the score is
    # a sum over a few hundred sites of terms of order 1.
    np.testing.assert_allclose(got.theta_trace[0], want["theta_trace"], rtol=0, atol=1e-12)
    assert not torch.equal(want["theta_trace"][0], want["theta_trace"][-1])
    np.testing.assert_allclose(got.final_score[0], want["final_score"], rtol=1e-10, atol=1e-10)


def test_reference_resampler_keeps_what_optimal_resampling_must():
    """Every particle with c W >= 1 is kept, heaviest first, the rest drawn
    from the others, M in all; the weights are the kept particles' own and
    -log c for the drawn."""
    rng = np.random.default_rng(2)
    w = torch.log(torch.tensor(rng.dirichlet(np.full(40, 0.3)), dtype=torch.float32))
    M = 30
    parents, new_w = ref.resample(w, M, 0.37)
    log_c = ref.tg.optimal_log_c(w.double(), M)
    heavy = torch.nonzero(w.double() + log_c >= 1e-6)[:, 0]
    assert parents.numel() == M and len(set(parents.tolist())) == M
    assert set(heavy.tolist()) <= set(parents[: heavy.numel()].tolist())
    assert torch.allclose(new_w[heavy.numel():].double(), torch.tensor(-log_c, dtype=torch.float64), rtol=1e-6)


# ---- the θ call's spans and counters ----------------------------------------------

def _write_counts(root, T=260):
    rng = np.random.default_rng(5)
    n = rng.poisson(15, (T, 2))
    y = rng.binomial(n, np.where(np.arange(T) % 120 < 60, 0.9, 0.1)[:, None])
    files = {}
    for name, cols in (("n_total", n), ("n_meth", y), ("pos", (np.arange(1, T + 1) * 10)[:, None])):
        path = root / f"{name}.csv.gz"
        head = "genomic_positions" if name == "pos" else "sample_1,sample_2"
        with gzip.open(path, "wt") as f:
            f.write(head + "\n" + "".join(",".join(map(str, r)) + "\n" for r in cols.tolist()))
        files[name] = str(path)
    return files, T


def _theta_call(root, files):
    out = lambda stem: str(root / f"{stem}.csv")
    return estimate_parameters_and_regimes(
        n_methylated_reads_csv_file=files["n_meth"], genomic_positions_csv_file=files["pos"],
        n_total_reads_csv_file=files["n_total"], device="cpu", u=3, n_particles=40,
        estimate_regime_probabilities=True, estimate_parameters=True, n_steps_without_parameter_update=50,
        rng_seed=3, regime_probabilities_csv_file=out("regimes"), theta_trace_csv_file=out("trace"),
        p_csv_file=out("p"), omega_csv_file=out("omega"), kappa_csv_file=out("kappa"), theta_file=out("theta"))


@pytest.fixture(scope="module")
def theta_calls(tmp_path_factory):
    """The same θ call with the recorder off, then on: (directories, both
    results, the second's spans and counters, T)."""
    root = tmp_path_factory.mktemp("theta_spans")
    files, T = _write_counts(root)
    (root / "off").mkdir()
    (root / "on").mkdir()
    spans.drain()
    off = _theta_call(root / "off", files)
    spans.enable()
    try:
        on = _theta_call(root / "on", files)
    finally:
        spans.disable()
    got, counters = spans.drain()
    return root, off, on, got, counters, T


def test_theta_call_with_the_recorder_on_computes_the_same_bits(theta_calls):
    root, off, on, *_ = theta_calls
    for a, b in zip(off, on):
        if torch.is_tensor(a):
            assert a.dtype == b.dtype and torch.equal(a, b)
    names = sorted(os.listdir(root / "off"))
    assert names == sorted(os.listdir(root / "on")) and len(names) == 6
    for name in names:
        assert (root / "off" / name).read_bytes() == (root / "on" / name).read_bytes(), name


def test_theta_call_records_its_phases_and_site_classes(theta_calls):
    *_, got, counters, T = theta_calls
    (call,) = [s for s in got if s.name == "theta.call"]
    assert call.attrs == {"units": 1, "sites": T} and all(s.call == call.id for s in got)
    children = sorted((s for s in got if s.parent == call.id), key=lambda s: s.start_ns)
    assert [s.name for s in children] == ["theta.read", "theta.tables", "theta.engine", "theta.write"]
    engine_span = children[2]
    eager = [s for s in got if s.name == "engine.eager"]
    assert eager and all(s.parent == engine_span.id for s in eager)
    assert sum(s.attrs["sites"] for s in eager) == counters["engine.sites.eager"]
    # The classes of _Engine.kind, site by site, for the call's engine.
    cfg = te.EngineConfig(n_particles_max=40, steps_per_update=50, estimate_parameters=True)
    model = make_model(MU, SIGMA, 3, [2.0] * R, device="cpu", d_max=64)
    eng = te._Engine(model, np.zeros(R * R), torch.zeros((T, R)), cfg, 1, torch.float32)
    kinds = [eng.kind(t) for t in range(1, T)]
    want = {"engine.sites.eager": kinds.count(None), "engine.sites.steady": kinds.count("steady"),
            "engine.sites.update": kinds.count("update")}
    assert {k: counters[k] for k in want} == want and sum(want.values()) == T - 1
    assert want["engine.sites.update"] == (T - 1) // 50
    # No span opens inside a site step: the loops' runs and the eager runs
    # are the engine's only children.
    assert {s.name for s in got if s.parent == engine_span.id} == {"engine.eager", "site_loop.run"}


def test_theta_call_with_the_recorder_off_records_nothing(theta_calls):
    spans.drain()
    root, *_ = theta_calls
    (root / "again" / "out").mkdir(parents=True)
    files, _ = _write_counts(root / "again")
    _theta_call(root / "again" / "out", files)
    assert spans.drain() == ([], {})


# ---- the θ cell's check at a small size -------------------------------------------

TINY = {"traffic": {"chromosome_sites": 2000, "sites_per_call": 1000, "warmup_sites": 100},
        "cell": {"check": {"steady_sites": 12, "update_sites": 3}}}


def _cell(seed):
    return harness.run_cell(bench=harness.load_json(harness.ROOT / "BENCHMARK.json"), cell_name="theta.chrom",
                            seed=seed, seconds=1e-6, trace=False, t_start=time.perf_counter(), device="cpu",
                            overrides=TINY)


def test_theta_cell_check_reads_nothing_on_the_ports_own_run():
    result, checks = _cell(2**31 + 7)
    assert result["correct"], checks
    read = {c["name"]: c["value"] for c in checks}
    assert read["states"] == read["k1_survivors"] == read["k1_heavy_dropped"] == 0
    assert read["weights_tv"] < 1e-4 and read["theta_gap"] < 1e-5 and read["regime_gap"] < 1e-5


@pytest.mark.parametrize("fault", sorted(faults_theta.FAULTS))
def test_theta_cell_check_catches_each_planted_fault(monkeypatch, fault):
    plant, number = faults_theta.FAULTS[fault]
    plant(monkeypatch)
    # This seed's chain resamples optimally at checked sites: where float32
    # finds no c (most weights below its range), the engine keeps the M
    # heaviest and a fault in K1's draw has nothing to act on.
    result, checks = _cell(12)
    read = {c["name"]: c for c in checks}[number]
    assert result["correct"] is False and read["value"] > read["limit"]
