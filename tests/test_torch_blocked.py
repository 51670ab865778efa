"""The port's engine extensions (per-unit tables, ``adam_init``, ``t_limit``)
and its blocked theta stage (hygeia_tpu_torch.single_group.blocked) against
the JAX package's on the same inputs, made with numpy from a seed, and the
same draws (the uniforms JAX derives from its keys).

Tolerances, at f64 (the JAX engine's own dtype argument; its blocked path
is run at f64 by swapping its module's float32 names for float64):
- regime_valid, spill counts and ADAM counts equal; regime probabilities
  atol 1.2e-7 (stored in float32 by both packages: one float32 ulp at 1);
- theta traces, final theta and score rtol 1e-9 with atol 1e-8 and logZ
  rtol 1e-9, as tests/test_torch_single_group.py's draw-for-draw test;
- a unit's live prefix under t_limit, and a unit of a per-unit-table call,
  against its own one-unit run: equal bit for bit, but logZ under t_limit
  rtol 1e-13 (a sum of T shifts with zeros past the limit adds in other
  lanes than a sum of t_limit shifts).
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hygeia_tpu.ops.emissions import emission_log_prob_table as j_emission
from hygeia_tpu.single_group import blocked as jb
from hygeia_tpu.single_group import engine as je
from hygeia_tpu.single_group import model as jm
from hygeia_tpu_torch.single_group import blocked as tb
from hygeia_tpu_torch.single_group import engine as te
from tests.test_torch_single_group import _jax_uniforms, _port_model

torch.set_num_threads(1)

F64 = torch.float64
R = 3
SALT = 1_000_003


def _setup(T, seed=0, run=30):
    """R=3 regimes in runs of ~``run`` sites, Poisson(25) depth, 2 samples;
    theta near the chain that made them."""
    rng = np.random.default_rng(seed)
    mu = np.array([0.1, 0.5, 0.9])
    model = jm.make_model(mu, np.full(R, 0.08), 2, np.full(R, 2.0), d_max=256, dtype=jnp.float64)
    P = np.array([[0.0, 0.7, 0.3], [0.5, 0.0, 0.5], [0.2, 0.8, 0.0]])
    theta = jm.parameters_to_theta(P, np.array([0.9, 0.85, 0.9]))
    regime = np.repeat(rng.integers(0, R, T // run + 1), run)[:T]
    n = rng.poisson(25, size=(T, 2)).astype(np.float64)
    y = rng.binomial(n.astype(int), mu[regime][:, None]).astype(np.float64)
    E = np.asarray(j_emission(y, n, model.alpha, model.beta, dtype=jnp.float64))
    return model, theta + rng.normal(scale=0.3, size=theta.size), E, regime


CFG = dict(n_particles_max=30, smoothing_window=32, steps_per_update=10,
           estimate_regimes=True, estimate_parameters=True)
M = CFG["n_particles_max"] - R


def _uniforms(key, T):
    us, um = _jax_uniforms(key, T, M)
    return us[:, 0], um[:, 0]


def _close(got, want, name, rtol=1e-9, atol=1e-8):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol, err_msg=name)


# ------------------------------------------------------- engine extensions ----

def test_per_unit_tables_equal_one_unit_runs():
    """Three units with their own (T, R) tables and thetas in one call: each
    unit's result equals its own one-unit run bit for bit."""
    model, theta, _, _ = _setup(8)
    tmodel, _ = _port_model(model, theta)
    Es, thetas, draws = [], [], []
    for s in range(3):
        _, th, E, _ = _setup(60, seed=s + 1)
        Es.append(E[:50])
        thetas.append(th)
        draws.append(_uniforms(jax.random.PRNGKey(s), 50))
    cfg = te.EngineConfig(**CFG)
    us = np.stack([d[0] for d in draws], axis=1)
    um = np.stack([d[1] for d in draws], axis=1)
    got = te.run_online_combined_inference(tmodel, torch.tensor(np.stack(thetas)), torch.tensor(np.stack(Es)),
                                           cfg, n_units=3, u_sys=us, u_mult=um, weight_dtype=F64)
    for u in range(3):
        one = te.run_online_combined_inference(tmodel, torch.tensor(thetas[u]), torch.tensor(Es[u]), cfg,
                                               u_sys=us[:, u : u + 1], u_mult=um[:, u : u + 1], weight_dtype=F64)
        for name in ("regime_probs", "regime_valid", "theta_trace", "final_theta", "final_score",
                     "log_normalizing_constant", "spill_count"):
            assert torch.equal(getattr(got, name)[u], getattr(one, name)[0]), (u, name)


@pytest.mark.parametrize("adam", [False, True])
def test_adam_init_and_t_limit_match_jax_draw_for_draw(adam):
    """Two units of lengths 60 and 37 (t_limit) in one call, warm ADAM state
    or none, against JAX's engine run per unit with the same t_limit and
    adam_init; then unit 1's live prefix against its one-unit run of 37
    sites."""
    model, theta, E0, _ = _setup(60, seed=3)
    _, _, E1, _ = _setup(60, seed=4)
    D = theta.size
    rng = np.random.default_rng(5)
    adam_init = (rng.normal(scale=0.01, size=(2, D)), rng.uniform(1e-3, 1e-2, size=(2, D)), np.array([3, 7]))
    lims = [60, 37]
    keys = [jax.random.PRNGKey(1), jax.random.PRNGKey(2)]
    Es = [E0, E1]
    refs = []
    for u in range(2):
        kw = dict(t_limit=lims[u])
        if adam:
            kw["adam_init"] = (adam_init[0][u], adam_init[1][u], int(adam_init[2][u]))
        refs.append(je.run_online_combined_inference(keys[u], model, theta, jnp.asarray(Es[u]),
                                                     je.EngineConfig(**CFG), weight_dtype=jnp.float64, **kw))
    draws = [_uniforms(k, 60) for k in keys]
    us = np.stack([d[0] for d in draws], axis=1)
    um = np.stack([d[1] for d in draws], axis=1)
    tmodel, ttheta = _port_model(model, theta)
    kw = dict(adam_init=adam_init) if adam else {}
    got = te.run_online_combined_inference(tmodel, ttheta, torch.tensor(np.stack(Es)), te.EngineConfig(**CFG),
                                           n_units=2, u_sys=us, u_mult=um, weight_dtype=F64, t_limit=lims, **kw)
    for u, ref in enumerate(refs):
        n = lims[u]
        assert int(got.spill_count[u]) == int(ref.spill_count)
        assert int(got.final_opt_state[2][u]) == int(ref.final_opt_state[2])
        np.testing.assert_array_equal(got.regime_valid[u, :n].numpy(), np.asarray(ref.regime_valid)[:n])
        np.testing.assert_allclose(got.regime_probs[u, :n].numpy(), np.asarray(ref.regime_probs)[:n],
                                   rtol=0, atol=1.2e-7)
        _close(got.theta_trace[u, :n], np.asarray(ref.theta_trace)[:n], "theta_trace")
        _close(got.final_theta[u], ref.final_theta, "final_theta")
        _close(got.final_score[u], ref.final_score, "final_score", atol=1e-7)
        _close(got.final_opt_state[0][u], ref.final_opt_state[0], "adam_m")
        _close(got.log_normalizing_constant[u], ref.log_normalizing_constant, "logZ", atol=0)
    one = te.run_online_combined_inference(
        tmodel, ttheta, torch.tensor(E1[:37]), te.EngineConfig(**CFG), u_sys=us[:36, 1:], u_mult=um[:36, 1:],
        weight_dtype=F64, **({"adam_init": tuple(a[1] for a in adam_init)} if adam else {}))
    for name in ("regime_probs", "regime_valid", "theta_trace"):
        assert torch.equal(getattr(got, name)[1, :37], getattr(one, name)[0]), name
    for name in ("final_theta", "final_score", "spill_count"):
        assert torch.equal(getattr(got, name)[1], getattr(one, name)[0]), name
    assert torch.equal(got.final_opt_state[2][1], one.final_opt_state[2][0])
    # logZ sums 60 shifts, 23 of them 0, against 37: other lanes of the sum.
    _close(got.log_normalizing_constant[1], one.log_normalizing_constant[0], "logZ", rtol=1e-13, atol=0)


def test_regime_pass_off_skips_the_smoothing_work(monkeypatch):
    """estimate_regimes=False (the warmup chain's setting) never enters the
    smoothing update; theta and logZ are those of the run with it on."""
    model, theta, E, _ = _setup(40, seed=6)
    tmodel, ttheta = _port_model(model, theta)
    us, um = _uniforms(jax.random.PRNGKey(3), 40)
    run = functools.partial(te.run_online_combined_inference, tmodel, ttheta, torch.tensor(E),
                            u_sys=us[:, None], u_mult=um[:, None], weight_dtype=F64)
    on = run(te.EngineConfig(**CFG))
    monkeypatch.setattr(te._Engine, "_smooth", lambda *a, **k: pytest.fail("smoothing ran"))
    off = run(te.EngineConfig(**dict(CFG, estimate_regimes=False)))
    assert torch.equal(on.theta_trace, off.theta_trace)
    assert torch.equal(on.log_normalizing_constant, off.log_normalizing_constant)


def test_shared_draws_give_every_unit_the_one_unit_run():
    """shared_draws: every unit takes the draws a one-unit run on the same
    generator takes (JAX's batched theta stage gives every chromosome one
    key); with t_limit each unit's prefix is then its sequential run."""
    model, theta, E, _ = _setup(50, seed=7)
    _, _, E2, _ = _setup(50, seed=8)
    tmodel, ttheta = _port_model(model, theta)
    cfg = te.EngineConfig(**CFG)
    both = te.run_online_combined_inference(tmodel, ttheta, torch.tensor(np.stack([E, E2])), cfg, n_units=2,
                                            generator=torch.Generator().manual_seed(9), shared_draws=True,
                                            t_limit=[50, 31], weight_dtype=F64)
    for u, (Eu, n) in enumerate(((E, 50), (E2[:31], 31))):
        one = te.run_online_combined_inference(tmodel, ttheta, torch.tensor(Eu), cfg,
                                               generator=torch.Generator().manual_seed(9), weight_dtype=F64)
        assert torch.equal(both.regime_probs[u, :n], one.regime_probs[0])
        assert torch.equal(both.theta_trace[u, :n], one.theta_trace[0])
        assert torch.equal(both.log_normalizing_constant[u], one.log_normalizing_constant[0])


# ----------------------------------------------------------------- blocked ----

class _Float64Names:
    """A module seen with float32 meaning float64: JAX's blocked path casts
    to float32 by name; through this it runs at f64."""

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        return getattr(self._mod, "float64" if name == "float32" else name)


@pytest.fixture
def jax_blocked_f64(monkeypatch):
    monkeypatch.setattr(jb, "np", _Float64Names(np))
    monkeypatch.setattr(jb, "jnp", _Float64Names(jnp))
    monkeypatch.setattr(jb, "run_online_combined_inference",
                        functools.partial(je.run_online_combined_inference, weight_dtype=jnp.float64))
    jb._PROGRAMS.clear()
    yield jb
    jb._PROGRAMS.clear()


def _jax_draws(key):
    """uniforms(T, block) as the JAX blocked path draws them."""
    def uniforms(T, block):
        k = key if block is None else jax.random.fold_in(key, SALT + block)
        return _uniforms(k, T)
    return uniforms


GEOM = dict(block_size=200, halo=40, warmup_sites=150)


def _assert_blocked_equal(got, ref, n_sites):
    assert got.regime_probs.shape == (n_sites, R)
    np.testing.assert_array_equal(got.regime_valid, np.asarray(ref.regime_valid))
    np.testing.assert_allclose(got.regime_probs, np.asarray(ref.regime_probs), rtol=0, atol=1.2e-7)
    _close(got.theta_trace, ref.theta_trace, "theta_trace")
    _close(got.final_theta, ref.final_theta, "final_theta")
    _close(got.final_score, ref.final_score, "final_score", atol=1e-7)
    _close(got.log_normalizing_constant, ref.log_normalizing_constant, "logZ", atol=0)
    assert int(got.spill_count) == int(ref.spill_count)


@pytest.mark.parametrize("T", [600, 530])
def test_blocked_matches_jax_draw_for_draw(jax_blocked_f64, T):
    """Warmup over 150 sites, then 3 windows of 240 (the last anchored at
    the end: at T=530 it overlaps its predecessor by 110 sites)."""
    model, theta, E, _ = _setup(T, seed=10)
    key = jax.random.PRNGKey(11)
    ref = jax_blocked_f64.run_online_combined_inference_blocked(key, model, theta, E, je.EngineConfig(**CFG),
                                                                **GEOM)
    tmodel, ttheta = _port_model(model, theta)
    got = tb.run_online_combined_inference_blocked(tmodel, ttheta, torch.tensor(E), te.EngineConfig(**CFG),
                                                   uniforms=_jax_draws(key), weight_dtype=F64, **GEOM)
    _assert_blocked_equal(got, ref, T)
    np.testing.assert_array_equal(got.theta_trace[-1], got.final_theta)


def test_blocked_single_block_equals_sequential():
    """A chromosome shorter than two blocks takes the sequential engine:
    the same result as run_online_combined_inference on the same
    generator."""
    model, theta, E, _ = _setup(180, seed=12)
    tmodel, ttheta = _port_model(model, theta)
    cfg = te.EngineConfig(**CFG)
    got = tb.run_online_combined_inference_blocked(tmodel, ttheta, torch.tensor(E), cfg,
                                                   generator=torch.Generator().manual_seed(2),
                                                   weight_dtype=F64, **GEOM)
    seq = te.run_online_combined_inference(tmodel, ttheta, torch.tensor(E), cfg,
                                           generator=torch.Generator().manual_seed(2), weight_dtype=F64)
    np.testing.assert_array_equal(got.regime_probs, seq.regime_probs[0].numpy())
    np.testing.assert_array_equal(got.theta_trace, seq.theta_trace[0].numpy())
    assert got.log_normalizing_constant == seq.log_normalizing_constant.item()


def test_blocked_warmup_is_the_sequential_prefix():
    """With a generator the warmup chain takes the draws of the caller's
    generator from its state at the call: its trace is the sequential
    chain's prefix, bit for bit (JAX: the warmup uses ``key``)."""
    model, theta, E, _ = _setup(600, seed=13)
    tmodel, ttheta = _port_model(model, theta)
    cfg = te.EngineConfig(**CFG)
    got = tb.run_online_combined_inference_blocked(tmodel, ttheta, torch.tensor(E), cfg,
                                                   generator=torch.Generator().manual_seed(4),
                                                   weight_dtype=F64, **GEOM)
    seq = te.run_online_combined_inference(tmodel, ttheta, torch.tensor(E[:150]), cfg,
                                           generator=torch.Generator().manual_seed(4), weight_dtype=F64)
    np.testing.assert_array_equal(got.theta_trace[:150], seq.theta_trace[0].numpy())
    assert np.isfinite(got.regime_probs).all() and got.regime_valid.all()


def test_blocked_multi_matches_per_chromosome(jax_blocked_f64):
    """Two chromosomes (600 and 450 sites: 3 and 3 blocks) and a short one
    (170: sequential) in one call: each chromosome's result equals its own
    blocked run with the same draws, and JAX's _multi."""
    model, theta, E0, _ = _setup(600, seed=14)
    _, theta1, E1, _ = _setup(450, seed=15)
    _, _, E2, _ = _setup(170, seed=16)
    key = jax.random.PRNGKey(17)
    tmodel, _ = _port_model(model, theta)
    cfg = te.EngineConfig(**CFG)
    thetas, Es = [theta, theta1, theta], [E0, E1, E2]
    got = tb.run_online_combined_inference_blocked_multi(
        tmodel, [torch.tensor(t) for t in thetas], [torch.tensor(e) for e in Es], cfg,
        uniforms=_jax_draws(key), weight_dtype=F64, **GEOM)
    refs = jax_blocked_f64.run_online_combined_inference_blocked_multi(key, model, thetas, Es,
                                                                      je.EngineConfig(**CFG), **GEOM)
    for c in range(3):
        _assert_blocked_equal(got[c], refs[c], Es[c].shape[0])
    # Alone, each chromosome's warmup is cropped to min(T_c, 150) = 150 as in
    # the batch, so its run is the same.
    for c in range(2):
        one = tb.run_online_combined_inference_blocked(tmodel, torch.tensor(thetas[c]), torch.tensor(Es[c]), cfg,
                                                       uniforms=_jax_draws(key), weight_dtype=F64, **GEOM)
        np.testing.assert_array_equal(one.regime_probs, got[c].regime_probs)
        np.testing.assert_array_equal(one.theta_trace, got[c].theta_trace)
        assert one.log_normalizing_constant == got[c].log_normalizing_constant


def test_blocked_recovers_regimes_like_sequential():
    """Fixed theta: the blocked regime modes agree with the sequential
    chain's on more than 95% of the sites (tests/test_blocked_engine.py's
    bound), and both find the planted regimes."""
    model, theta, E, regime = _setup(900, seed=18)
    tmodel, ttheta = _port_model(model, theta)
    cfg = te.EngineConfig(**dict(CFG, n_particles_max=60, estimate_parameters=False))
    seq = te.run_online_combined_inference(tmodel, ttheta, torch.tensor(E), cfg,
                                           generator=torch.Generator().manual_seed(5), weight_dtype=F64)
    blk = tb.run_online_combined_inference_blocked(tmodel, ttheta, torch.tensor(E), cfg,
                                                   generator=torch.Generator().manual_seed(5),
                                                   weight_dtype=F64, block_size=300, halo=100)
    p_seq, p_blk = seq.regime_probs[0].numpy(), blk.regime_probs
    assert (p_blk.argmax(1) == p_seq.argmax(1)).mean() > 0.95
    assert (p_blk.argmax(1) == regime).mean() > 0.9
    np.testing.assert_array_equal(blk.theta_trace[-1], ttheta.numpy())
