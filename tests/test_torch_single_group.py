"""The port's single-group slice (hygeia_tpu_torch.single_group) against the
JAX package's on the same inputs, made with numpy from a seed.

Tolerances:
- tables and theta packing at f64: rtol 1e-12, exit latch equal. The pmf
  terms are computed in other ways (a sum of log1p terms against three
  lgammas) and round differently in the last bits; the depth (32) keeps
  the survival 1 - big_h_prev away from 0, which would amplify them, and
  the lgamma arguments small (at ~60 their f64 rounding alone reaches 1e-12);
- the engine against the exact forward-backward oracle: logZ rtol 1e-9,
  marginals atol 1e-8 (the JAX test's own);
- the engine against JAX draw for draw (the uniforms JAX derives from
  fold_in(key, t)): spill count and regime_valid equal; logZ rtol 1e-9
  (f64 sums taken in other orders). The theta trace and the final score
  also rtol 1e-9, plus atol 1e-8 and 1e-7: the score is a weighted sum of
  per-particle terms of up to ~1e3 (the kappa gradient at sojourn ~60) that
  cancel, so rounding of the tables (~1e-12, lgamma against log1p sums) and
  of the sums reaches ~1e-8 of it (measured 1.2e-8), and ADAM divides each
  step by the RMS of its gradient, which carries that into theta where a
  gradient is near 0 (measured 5.6e-9). The regime probabilities are stored in
  float32, as JAX stores them, so f64 means that agree to 1e-9 may round to
  neighbouring floats: atol 1.2e-7, one float32 ulp at 1;
- the CLI with the regime probabilities only: the mean |port - JAX seed s|
  over JAX seeds 0-2 at most twice the mean |JAX seed a - JAX seed b| over
  their pairs, measured here (one pair alone is too noisy a yardstick: the
  six pairs of four seeds ranged 1.5e-4 to 2.7e-4).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hygeia_tpu.cli import main as jax_cli
from hygeia_tpu.ops.emissions import emission_log_prob_table as j_emission
from hygeia_tpu.single_group import engine as je
from hygeia_tpu.single_group import model as jm
from hygeia_tpu_torch import cli as torch_cli
from hygeia_tpu_torch.single_group import engine as te
from hygeia_tpu_torch.single_group import model as tm
from hygeia_tpu_torch.utils import io as tio
from tests.test_single_group_engine import _exact_forward_backward, _make_setup

# The tensors here are small: one intra-op thread per test worker keeps the
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
F64 = torch.float64


def _port_model(model, theta, dtype=F64):
    return tm.model_from_numpy({k: np.asarray(v) for k, v in model._asdict().items()}, theta, dtype=dtype,
                               device="cpu")


def _random_theta(R, rng, kappa_fixed=True):
    P = rng.dirichlet(np.ones(R - 1), size=R)
    Pfull = np.zeros((R, R))
    for r in range(R):
        Pfull[r, [c for c in range(R) if c != r]] = P[r]
    omega = rng.uniform(0.85, 0.99, R)
    kappa = rng.uniform(1.5, 3.0, R)
    return Pfull, omega, kappa, jm.parameters_to_theta(Pfull, omega, kappa, kappa_fixed=kappa_fixed)


# ---------------------------------------------------------------- tables ----

def test_theta_packing_matches_jax():
    rng = np.random.default_rng(9)
    for kappa_fixed in (True, False):
        Pfull, omega, kappa, want = _random_theta(4, rng, kappa_fixed)
        got = tm.parameters_to_theta(Pfull, omega, kappa, kappa_fixed=kappa_fixed)
        np.testing.assert_allclose(got, want, rtol=1e-12)
        back_j = jm.theta_to_parameters(want, 4, kappa_fixed=kappa_fixed)
        back_t = tm.theta_to_parameters(got, 4, kappa_fixed=kappa_fixed)
        assert set(back_j) == set(back_t)
        for k in back_j:
            np.testing.assert_allclose(back_t[k], back_j[k], rtol=1e-12, err_msg=k)
        np.testing.assert_allclose(back_t["p"], Pfull, rtol=1e-10)
        np.testing.assert_allclose(back_t["omega"], omega, rtol=1e-10)


@pytest.mark.parametrize("kappa_fixed", [True, False])
def test_build_tables_match_jax_f64(kappa_fixed):
    R = 6
    rng = np.random.default_rng(11)
    _, _, kappa, theta = _random_theta(R, rng, kappa_fixed)
    model = jm.make_model(np.linspace(0.1, 0.9, R), np.full(R, 0.08), 2, kappa,
                          kappa_fixed=kappa_fixed, d_max=32, dtype=jnp.float64)
    want = jm.build_tables(model, jnp.asarray(theta))
    got = tm.build_tables(*_port_model(model, theta))
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.shape == w.shape, name
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w), err_msg=name)
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-12, atol=1e-300, err_msg=name)


def test_transition_log_densities_match_jax_f64():
    rng = np.random.default_rng(2)
    theta = _random_theta(3, rng)[3]
    model = jm.make_model(np.linspace(0.1, 0.9, 3), np.full(3, 0.08), 2, np.full(3, 2.0),
                          d_max=32, dtype=jnp.float64)
    jt = jm.build_tables(model, jnp.asarray(theta))
    tt = tm.build_tables(*_port_model(model, theta))
    d = rng.integers(0, 40, 200)  # past the depth (32) too: clamped
    r = rng.integers(0, 3, 200)
    q = rng.integers(0, 3, 200)
    want = np.asarray(jm.continuation_log_density(jt, jnp.asarray(d), jnp.asarray(r)))
    got = tm.continuation_log_density(tt, torch.from_numpy(d), torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    want = np.asarray(jm.change_point_log_density(jt, model.u, jnp.asarray(q), jnp.asarray(d), jnp.asarray(r)))
    got = tm.change_point_log_density(tt, model.u, torch.from_numpy(q), torch.from_numpy(d),
                                      torch.from_numpy(r)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12)


# The exit-latch onsets (first latched column per regime, -1: none) of the
# JAX package's f32 tables at d_max 4096: the CLI defaults, then three
# seeded theta. The port's f32 tables are JAX's bit for bit (XLA's CPU
# float32 elementary functions replayed, ops/xla_f32.py) and the same on
# every device (tests/test_torch_cuda.py and chip_smoke.py hold the card to
# them).
ONSETS = [
    [3728, -1, -1, -1, -1, -1],
    [3551, 428, 437, -1, 190, 231],
    [1611, 372, -1, 295, 118, 331],
    [-1, -1, -1, -1, 234, 132],
]


def _onsets(exit_status):
    ex = np.asarray(exit_status)
    return [int(r.argmax()) if r.any() else -1 for r in ex]


@pytest.mark.parametrize("case", range(4))
def test_f32_latch_onsets_against_jax(case):
    """Both packages latch at the recorded onsets; every f32 table is
    JAX's bit for bit; and the f32 tables are within rtol 1e-2 of the
    port's f64 tables where the survival 1 - big_h_prev exceeds 0.1 (XLA's
    f32 lgamma loses ~1e-3 there to the cancellation of three lgammas of
    ~1e3; measured 3.7e-3)."""
    R = 6
    p = np.full((R, R), 1.0 / (R - 1))
    np.fill_diagonal(p, 0.0)
    theta = jm.parameters_to_theta(p, np.array([0.995, 0.975, 0.95, 0.925, 0.9, 0.9]))
    if case:
        theta = theta + np.random.default_rng(99 + case).normal(scale=0.5, size=theta.size)
    model = jm.make_model(np.array([0.99, 0.01, 0.8, 0.2, 0.5, 0.5]),
                          np.array([0.05, 0.05, 0.2, 0.2, 0.2, 0.2886751]), 2, np.full(R, 2.0), d_max=4096)
    want = jm.build_tables(model, jnp.asarray(theta, jnp.float32))
    got = tm.build_tables(*_port_model(model, theta, dtype=torch.float32))
    got64 = tm.build_tables(*_port_model(model, theta))
    assert _onsets(want.exit_status) == _onsets(got.exit_status) == ONSETS[case]
    for name in ("omega", "kappa", "rho", "exit_status", "grad_omega_log_rho", "grad_kappa_log_rho"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)

    # Survival from an independent f64 evaluation of the pmf.
    kap, om = got64.kappa[:, None], got64.omega[:, None]
    d = torch.arange(1, 4097, dtype=F64)
    x = torch.clamp(d - 2, min=0)
    lp = (torch.lgamma(x + kap) - torch.lgamma(kap) - torch.lgamma(x + 1)
          + kap * torch.log1p(-om) + x * torch.log(om))
    h = torch.where(d >= 2, torch.exp(lp), 0.0)
    surv = (1 - (torch.cumsum(h, 1) - h)).numpy() > 0.1
    for name in ("rho", "grad_omega_log_rho"):
        g32, g64 = getattr(got, name).numpy(), getattr(got64, name).numpy()
        np.testing.assert_allclose(g32[surv], g64[surv], rtol=1e-2, err_msg=name)


@pytest.mark.parametrize("kappa_fixed", [True, False])
def test_chip_smoke_pins_the_jax_onsets(kappa_fixed):
    """chip_smoke.py holds the card's f32 latch onsets at the CLI defaults
    to JAX_ONSETS (the card's machine has no JAX): they are the JAX
    package's, at the smoke's own theta, and the port's on the CPU."""
    import chip_smoke

    R = 6
    p = np.full((R, R), 1.0 / (R - 1))
    np.fill_diagonal(p, 0.0)
    omega, kappa = np.array([0.995, 0.975, 0.950, 0.925, 0.900, 0.900]), np.full(R, 2.0)
    sigma = (0.05, 0.05, 0.20, 0.20, 0.20, 0.2886751)
    theta = tm.parameters_to_theta(p, omega, kappa, kappa_fixed=kappa_fixed)
    jmodel = jm.make_model(np.asarray(chip_smoke.SG_MU), np.asarray(sigma), 2, kappa,
                           kappa_fixed=kappa_fixed, d_max=4096)
    want = jm.build_tables(jmodel, jnp.asarray(theta, jnp.float32))
    tmodel = tm.make_model(chip_smoke.SG_MU, sigma, 2, kappa, kappa_fixed=kappa_fixed, d_max=4096,
                           device="cpu")
    got = tm.build_tables(tmodel, torch.as_tensor(theta, dtype=torch.float32))
    pin = [-1 if o is None else o for o in chip_smoke.JAX_ONSETS["kappa fixed" if kappa_fixed else "kappa free"]]
    assert _onsets(want.exit_status) == _onsets(got.exit_status) == pin


# ---------------------------------------------------------------- engine ----

def test_engine_exact_when_no_resampling():
    """N_max >= R(T+1): the filter covers the whole support, so logZ and
    (epsilon -> 0) the smoothing marginals are exact."""
    model, theta, E = _make_setup(R=3, T=12)
    log_z_exact, marg_exact = _exact_forward_backward(model, theta, E)
    cfg = te.EngineConfig(n_particles_max=3 * 14, epsilon=1e-12, smoothing_window=16,
                          estimate_regimes=True, estimate_parameters=False)
    tmodel, ttheta = _port_model(model, theta)
    res = te.run_online_combined_inference(
        tmodel, ttheta, torch.tensor(np.asarray(E)), cfg,
        generator=torch.Generator().manual_seed(0), weight_dtype=F64,
    )
    np.testing.assert_allclose(res.log_normalizing_constant.item(), log_z_exact, rtol=1e-9)
    assert int(res.spill_count[0]) == 0
    assert bool(res.regime_valid.all())
    np.testing.assert_allclose(res.regime_probs[0].numpy(), marg_exact, atol=1e-8)


def _jax_uniforms(key, T, M):
    """The resampler's uniforms of sites 1..T-1 as the JAX engine draws
    them: split(fold_in(key, t)) -> (systematic scalar, M multinomial)."""
    def draw(t):
        ks, km = jax.random.split(jax.random.fold_in(key, t))
        return (jax.random.uniform(ks, (), dtype=jnp.float32),
                jax.random.uniform(km, (M,), dtype=jnp.float32))

    us, um = jax.jit(jax.vmap(draw))(jnp.arange(1, T))
    return np.array(us)[:, None], np.array(um)[:, None]


def _production_setup(T, kappa_fixed, seed=5):
    """The CLI's defaults (R=6, mu, sigma, u=2, d_max 4096) with theta near
    a default (uniform P, omega 0.99-0.995, kappa 2), perturbed by
    N(0, 0.1^2). omega stays near 0.99, so up to T = 300 sojourns the
    survival 1 - big_h_prev stays above 1e-2. At omega ~ 0.9 it falls to
    ~1e-11 by sojourn 300, where rho and its gradients are ill-conditioned
    (both packages' f64 rho are ~1e-3 off the exact value there) and the
    filtered score, a sum of such terms, parts by more than rounding."""
    R = 6
    rng = np.random.default_rng(seed)
    mu = np.array([0.99, 0.01, 0.8, 0.2, 0.5, 0.5])
    model = jm.make_model(mu, np.array([0.05, 0.05, 0.2, 0.2, 0.2, 0.2886751]), 2, np.full(R, 2.0),
                          kappa_fixed=kappa_fixed, d_max=4096, dtype=jnp.float64)
    regime = np.repeat(rng.integers(0, R, T // 25 + 1), 25)[:T]
    n = rng.poisson(20, size=(T, 2)).astype(np.float64)
    y = rng.binomial(n.astype(int), mu[regime][:, None]).astype(np.float64)
    E = j_emission(y, n, model.alpha, model.beta, dtype=jnp.float64)
    p = np.full((R, R), 1.0 / (R - 1))
    np.fill_diagonal(p, 0.0)
    theta = jm.parameters_to_theta(p, np.array([0.995, 0.99, 0.99, 0.99, 0.99, 0.99]),
                                   np.full(R, 2.0), kappa_fixed=kappa_fixed)
    return model, theta + rng.normal(scale=0.1, size=theta.size), E


def _small_kappa_free_setup(T=40, seed=3):
    R = 3
    rng = np.random.default_rng(seed)
    model = jm.make_model(np.linspace(0.15, 0.85, R), np.full(R, 0.08), 2, np.full(R, 2.0),
                          kappa_fixed=False, d_max=64, dtype=jnp.float64)
    Pfull, omega, kappa, theta = _random_theta(R, rng, kappa_fixed=False)
    n = rng.poisson(25, size=(T, 2)).astype(np.float64)
    y = np.minimum(rng.poisson(10, size=(T, 2)), n)
    return model, theta, j_emission(y, n, model.alpha, model.beta, dtype=jnp.float64)


CASES = {
    "small": dict(setup=lambda: _make_setup(R=3, T=40, seed=3),
                  cfg=dict(n_particles_max=30, smoothing_window=32, steps_per_update=5)),
    "production": dict(setup=lambda: _production_setup(300, True),
                       cfg=dict(n_particles_max=250, smoothing_window=128, steps_per_update=50)),
    # A 3-entry smoothing buffer and a tight epsilon: 20 forced
    # finalisations (spills); the plain normalised-gradient update.
    "small_plain_gradient": dict(setup=lambda: _make_setup(R=3, T=40, seed=4),
                                 cfg=dict(n_particles_max=30, smoothing_window=3, epsilon=1e-4, steps_per_update=5,
                                          use_adam=False, normalise_gradients=True,
                                          learning_rate_factor=0.05)),
    "small_kappa_free": dict(setup=_small_kappa_free_setup,
                             cfg=dict(n_particles_max=30, smoothing_window=32, steps_per_update=5)),
    "production_kappa_free": dict(setup=lambda: _production_setup(150, False),
                                  cfg=dict(n_particles_max=250, smoothing_window=128, steps_per_update=25)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax_draw_for_draw(case):
    model, theta, E = CASES[case]["setup"]()
    cfg = dict(CASES[case]["cfg"], estimate_regimes=True, estimate_parameters=True)
    key = jax.random.PRNGKey(1)
    ref = je.run_online_combined_inference(key, model, theta, E, je.EngineConfig(**cfg),
                                           weight_dtype=jnp.float64)
    T = E.shape[0]
    us, um = _jax_uniforms(key, T, cfg["n_particles_max"] - model.n_regimes)
    tmodel, ttheta = _port_model(model, theta)
    got = te.run_online_combined_inference(tmodel, ttheta, torch.tensor(np.asarray(E)),
                                           te.EngineConfig(**cfg), u_sys=us, u_mult=um, weight_dtype=F64)
    assert int(got.spill_count[0]) == int(ref.spill_count)
    np.testing.assert_array_equal(got.regime_valid[0].numpy(), np.asarray(ref.regime_valid))
    assert got.regime_probs.dtype == torch.float32
    np.testing.assert_allclose(got.regime_probs[0].numpy(), np.asarray(ref.regime_probs),
                               rtol=0, atol=1.2e-7)
    for name, atol in (("theta_trace", 1e-8), ("final_score", 1e-7)):
        np.testing.assert_allclose(getattr(got, name)[0].numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=atol, err_msg=name)
    np.testing.assert_allclose(got.log_normalizing_constant.item(),
                               float(ref.log_normalizing_constant), rtol=1e-9)


def test_chunked_engine_matches_and_resumes(tmp_path, monkeypatch):
    """Chunked == one-shot (bit for bit: the same steps); a run killed after
    a checkpoint and resumed gives the same result; the checkpoint goes when
    the run completes. Uniforms from a generator, whose state the
    checkpoint carries."""
    model, theta, E = _make_setup(R=3, T=30, seed=3)
    tmodel, ttheta = _port_model(model, theta)
    E = torch.tensor(np.asarray(E))
    cfg = te.EngineConfig(n_particles_max=30, smoothing_window=32, estimate_parameters=True,
                          steps_per_update=5)

    def gen():
        return torch.Generator().manual_seed(4)

    full = te.run_online_combined_inference(tmodel, ttheta, E, cfg, n_units=2, generator=gen(),
                                            weight_dtype=F64)
    chunked = te.run_online_combined_inference_chunked(
        tmodel, ttheta, E, cfg, chunk_size=7, n_units=2, generator=gen(), weight_dtype=F64)
    for a, b in zip(full, chunked):
        if torch.is_tensor(a):
            assert torch.equal(a, b)

    ck = tmp_path / "engine_ck.npz"
    real_remove = os.remove
    monkeypatch.setattr(os, "remove", lambda p: None)  # the "kill": the checkpoint survives
    te.run_online_combined_inference_chunked(tmodel, ttheta, E, cfg, chunk_size=7, n_units=2,
                                             generator=gen(), checkpoint_path=str(ck), weight_dtype=F64)
    monkeypatch.setattr(os, "remove", real_remove)
    assert ck.exists()
    with np.load(ck) as z:
        assert int(z["next_t"]) == 29  # the last chunk's start: 1 + 4 * 7
    resumed = te.run_online_combined_inference_chunked(
        tmodel, ttheta, E, cfg, chunk_size=7, n_units=2, generator=gen(),
        checkpoint_path=str(ck), resume=True, weight_dtype=F64)
    assert not ck.exists()
    for a, b in zip(full, resumed):
        if torch.is_tensor(a):
            assert torch.equal(a, b)
    assert torch.equal(resumed.final_opt_state[2], full.final_opt_state[2])


# ------------------------------------------------------------------- CLI ----

@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The tests/test_pipeline.py single-group fixture (simulate_data, 400
    sites, 2 samples) through both packages' estimate_parameters_and_regimes."""
    root = tmp_path_factory.mktemp("torch_sg_cli")
    sim = root / "sim"
    sim.mkdir()
    jax_cli(["simulate_data", "--n_cpg_sites", "400", "--n_samples", "2", "--u", "2", "--rng_seed", "1",
             "--regimes_csv_file", str(sim / "regimes.csv"),
             "--n_methylated_reads_csv_file", str(sim / "meth.csv"),
             "--genomic_positions_csv_file", str(sim / "pos.csv"),
             "--n_total_reads_csv_file", str(sim / "total.csv")])
    inputs = ["--n_methylated_reads_csv_file", str(sim / "meth.csv"),
              "--genomic_positions_csv_file", str(sim / "pos.csv"),
              "--n_total_reads_csv_file", str(sim / "total.csv"), "--u", "2", "--n_particles", "60"]

    def outputs(d):
        return ["--regime_probabilities_csv_file", str(d / "regime_probs.csv"),
                "--theta_trace_csv_file", str(d / "theta_trace.csv"),
                "--p_csv_file", str(d / "p.csv"), "--omega_csv_file", str(d / "omega.csv"),
                "--kappa_csv_file", str(d / "kappa.csv"), "--theta_file", str(d / "theta_1.csv.gz")]

    both = ["--estimate_regime_probabilities", "--estimate_parameters", "--n_steps_without_parameter_update", "50"]
    runs = {}
    for name, cli, extra in (("jax_both", jax_cli, both), ("torch_both", torch_cli.main, both + ["--device", "cpu"])):
        d = root / name
        cli(["estimate_parameters_and_regimes", *inputs, *extra, *outputs(d), "--progress_every", "0"])
        runs[name] = d
    for name, cli, seed, extra in (("jax_probs_0", jax_cli, 0, []), ("jax_probs_1", jax_cli, 1, []),
                                   ("jax_probs_2", jax_cli, 2, []),
                                   ("torch_probs_0", torch_cli.main, 0, ["--device", "cpu"])):
        d = root / name
        cli(["estimate_parameters_and_regimes", *inputs, "--estimate_regime_probabilities",
             "--rng_seed", str(seed), "--regime_probabilities_csv_file", str(d / "regime_probs.csv"),
             "--progress_every", "0", *extra])
        runs[name] = d
    runs["sim"] = sim
    return runs


def _header_and_shape(path):
    import gzip

    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    return lines[0], (len(lines) - 1, lines[0].count(",") + 1)


def test_cli_writes_the_jax_file_set(cli_runs):
    jd, td = cli_runs["jax_both"], cli_runs["torch_both"]
    names = sorted(os.listdir(jd))
    assert names == sorted(os.listdir(td)) and len(names) == 6
    for name in names:
        assert _header_and_shape(td / name) == _header_and_shape(jd / name), name
    _, shape = _header_and_shape(td / "regime_probs.csv")
    assert shape == (400, 7)
    probs = tio.read_headed_table(td / "regime_probs.csv")[1][:, 1:]
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-5)
    np.testing.assert_allclose(tio.read_headed_table(td / "p.csv")[1].sum(1), 1.0, atol=1e-12)


def test_cli_regime_probabilities_agree_within_the_seed_spread(cli_runs):
    def probs(name):
        return tio.read_headed_table(cli_runs[name] / "regime_probs.csv")[1][:, 1:]

    jax_runs = [probs(f"jax_probs_{s}") for s in range(3)]
    t0 = probs("torch_probs_0")
    spread = np.mean([np.abs(jax_runs[a] - jax_runs[b]).mean() for a, b in ((0, 1), (0, 2), (1, 2))])
    cross = np.mean([np.abs(t0 - j).mean() for j in jax_runs])
    assert cross <= 2 * spread, (cross, spread)
    truth = tio.read_headed_column(cli_runs["sim"] / "regimes.csv")
    assert np.mean(t0.argmax(1) == truth) > 0.7


def test_single_group_verb_imports_neither_jax_nor_pandas(tmp_path):
    """Run the verb in a fresh interpreter on a tiny input, then look at
    sys.modules."""
    rng = np.random.default_rng(0)
    n = rng.poisson(20, size=(2, 40))
    tio.write_headed_matrix(tmp_path / "total.csv", n, "sample")
    tio.write_headed_matrix(tmp_path / "meth.csv", rng.binomial(n, 0.5), "sample")
    tio.write_headed_column(tmp_path / "pos.csv", np.arange(40), "genomic_positions")
    code = (
        "import sys, hygeia_tpu_torch.cli as c, hygeia_tpu_torch.single_group.runner; "
        f"c.main(['estimate_parameters_and_regimes', '--n_methylated_reads_csv_file', r'{tmp_path / 'meth.csv'}', "
        f"'--n_total_reads_csv_file', r'{tmp_path / 'total.csv'}', '--genomic_positions_csv_file', "
        f"r'{tmp_path / 'pos.csv'}', '--estimate_parameters', '--estimate_regime_probabilities', "
        f"'--n_particles', '20', '--regime_probabilities_csv_file', r'{tmp_path / 'out.csv'}', "
        f"'--theta_file', r'{tmp_path / 'theta.csv'}', '--p_csv_file', r'{tmp_path / 'p.csv'}', "
        f"'--omega_csv_file', r'{tmp_path / 'o.csv'}', '--kappa_csv_file', r'{tmp_path / 'k.csv'}', "
        "'--device', 'cpu']); "
        "bad = [m for m in ('jax', 'pandas', 'hygeia_tpu') if m in sys.modules]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (tmp_path / "out.csv").exists() and (tmp_path / "theta.csv").exists()


def test_single_group_verb_device_cuda_raises_without_cuda(cli_runs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    sim = cli_runs["sim"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_cli.main([
            "estimate_parameters_and_regimes", "--n_methylated_reads_csv_file", str(sim / "meth.csv"),
            "--genomic_positions_csv_file", str(sim / "pos.csv"),
            "--n_total_reads_csv_file", str(sim / "total.csv"), "--estimate_regime_probabilities",
            "--regime_probabilities_csv_file", str(tmp_path / "out.csv"), "--device", "cuda",
        ])
    assert not any(tmp_path.iterdir())
