"""The port's two-group model, filter and backward pass against the JAX
package, at f64 on inputs made with numpy from a seed.

Exactness: integer results (child states, parents, sampled trajectories)
must be equal. Float results that pass through log/log1p/exp are compared
at rtol 1e-13: XLA's CPU transcendentals and libm's differ in the last bit
for ~15% of f64 inputs, so bit equality is not reachable; -inf masks must
be equal. Randomness is injected: the uniforms and the Gumbel noise are
derived from the JAX keys exactly as the JAX functions derive them.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.special import logsumexp

from hygeia_tpu.ops.emissions import emission_log_prob_table as j_emission
from hygeia_tpu.two_group import model as jm
from hygeia_tpu.two_group.backward import (
    _backward_logits as j_backward_logits,
    backward_simulation as j_backward,
)
from hygeia_tpu.two_group.filter import _one_step as j_one_step, run_filter as j_run_filter
from hygeia_tpu.two_group.proposal import expand_states as j_expand
from hygeia_tpu_torch.two_group import model as tm
from hygeia_tpu_torch.two_group.backward import (
    _backward_logits as t_backward_logits,
    backward_simulation as t_backward,
    smoothing_functionals as t_functionals,
)
from hygeia_tpu_torch.two_group.filter import _one_step as t_one_step, run_filter as t_run_filter
from hygeia_tpu_torch.two_group.proposal import expand_states as t_expand
from tests.test_two_group_filter import _enumerate_state_space
from tests.test_two_group_model import default_params

# The tensors here are small: one intra-op thread per test worker keeps the
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

F64 = torch.float64
RTOL = 1e-13


def _port_params(params):
    return tm.params_from_numpy({k: np.array(v) for k, v in params._asdict().items()}, device="cpu")


def _assert_close_masked(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want), err_msg=err_msg)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=1e-13, err_msg=err_msg)


def _random_ancestors(rng, R, M, dead_frac=0.2, d_hi=40):
    m = rng.integers(0, 2, M)
    d_c = rng.integers(0, d_hi, M)  # duration 0: merge children of merged parents
    r_c = rng.integers(0, R, M)
    d_k = np.where(m == 1, d_c, rng.integers(0, d_hi, M))
    r_k = np.where(m == 1, r_c, rng.integers(0, R, M))
    dead = rng.random(M) < dead_frac
    return [np.where(dead, -1, f).astype(np.int32) for f in (m, d_c, r_c, d_k, r_k)], dead


@pytest.mark.parametrize("R", [4, 6])
def test_expand_score_and_observe_matches_jax(R):
    """Two units of random ancestors (20% dead): children equal everywhere,
    transition and emission log-probs equal on live ancestors (masks
    exact); the port's dead ancestors get -inf throughout."""
    params = default_params(R=R, d_max=64)
    tp = _port_params(params)
    rng = np.random.default_rng(R)
    M = 23
    units = [_random_ancestors(rng, R, M) for _ in range(2)]
    row_c, row_k = rng.normal(size=R), rng.normal(size=R)
    tanc = tm.State(*(torch.from_numpy(np.stack([u[0][i] for u in units])) for i in range(5)))
    tc, tt, to = tm.expand_score_and_observe(tp, tanc, torch.tensor(row_c), torch.tensor(row_k))
    j_expand_score = jax.jit(lambda a, rc, rk: jm.expand_score_and_observe(params, a, rc, rk))
    j_transition = jax.jit(lambda prev, nxt: jm.transition_log_prob(params, prev, nxt))
    for u, (fields, dead) in enumerate(units):
        anc = jm.State(*(jnp.asarray(f) for f in fields))
        jc, jt, jo = j_expand_score(anc, jnp.asarray(row_c), jnp.asarray(row_k))
        for a, b in zip(jc, tc):
            np.testing.assert_array_equal(b[u].numpy(), np.asarray(a))
        live = ~np.broadcast_to(dead[None, :], jt.shape)
        _assert_close_masked(tt[u].numpy()[live], np.asarray(jt)[live], f"unit {u}")
        np.testing.assert_array_equal(to[u].numpy()[live], np.asarray(jo)[live])
        assert np.all(np.isneginf(tt[u].numpy()[~live]))

        # The generic density and the paired one, on the same expansion.
        ch = j_expand(anc, R)
        tch = t_expand(tm.State(*(f[u] for f in tanc)), R)
        for a, b in zip(ch, tch):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        want = np.asarray(j_transition(jm.State(*(f[None, :] for f in anc)), ch))
        got = tm.transition_log_prob(tp, tm.State(*(f[u][None, :] for f in tanc)), tch).numpy()
        _assert_close_masked(got[live], want[live], "transition_log_prob")
        got_p = tm.paired_transition_log_prob(tp, tm.State(*(f[u] for f in tanc)), tch).numpy()
        _assert_close_masked(got_p[live], want[live], "paired_transition_log_prob")


@pytest.fixture(scope="module")
def jax_history():
    """A JAX filter history (R=4, T=30, M=5) at f64: real history rows in
    the (I, M) child layout, with dead slots and resampled steps."""
    R, T, M = 4, 30, 5
    params = default_params(R=R, min_duration=2, d_max=128)
    rng = np.random.default_rng(3)
    n = rng.poisson(25, size=(T, 2)).astype(np.float64)
    y = np.minimum(rng.poisson(10, size=(T, 2)), n).astype(np.float64)
    E_c = j_emission(y, n, params.alpha, params.beta, dtype=jnp.float64)
    E_k = j_emission(np.minimum(y + 2, n), n, params.alpha, params.beta, dtype=jnp.float64)
    res = j_run_filter(jax.random.PRNGKey(0), params, E_c, E_k, M, weight_dtype=jnp.float64, unroll=1)
    return params, E_c, E_k, res


def test_one_step_matches_jax_with_injected_uniforms(jax_history):
    """One filter step for two units from two history rows, with the
    uniforms the JAX step draws from its key: parents and children equal,
    weights at rtol 1e-13 with equal -inf masks."""
    params, E_c, E_k, res = jax_history
    tp = _port_params(params)
    M = 5
    rows, t = (7, 19), 20
    keys = [jax.random.PRNGKey(100 + r) for r in rows]
    us, ums = [], []
    for k in keys:
        k_sys, k_mult = jax.random.split(k)
        us.append(float(jax.random.uniform(k_sys, (), dtype=jnp.float32)))
        ums.append(np.asarray(jax.random.uniform(k_mult, (M,), dtype=jnp.float32)))
    prev_lw = np.stack([np.asarray(res.log_weights[r]) for r in rows])
    prev = torch.from_numpy(
        np.stack([np.stack([np.asarray(f[r]) for f in res.particles]) for r in rows]).astype(np.int32)
    )  # (U, 5, N) stacked fields
    new_lw, new_parts = t_one_step(
        tp, torch.from_numpy(np.array(E_c[t])), torch.from_numpy(np.array(E_k[t])),
        torch.from_numpy(prev_lw), prev, M, torch.tensor(us), torch.from_numpy(np.stack(ums)),
    )
    step = jax.jit(lambda k, lw, prev: j_one_step(k, params, E_c, E_k, t, lw, prev, M, True, False))
    for u, r in enumerate(rows):
        jprev = jm.State(*(jnp.asarray(f[r]).astype(jnp.int32) for f in res.particles))
        want_lw, want_parts = step(keys[u], jnp.asarray(prev_lw[u]), jprev)
        _assert_close_masked(new_lw[u].numpy(), want_lw, f"row {r}")
        for i, a in enumerate(want_parts):
            np.testing.assert_array_equal(new_parts[u, i].numpy(), np.asarray(a))

    # Emission lookup at the history's particle regimes, on live slots.
    hist = jm.State(*(jnp.asarray(f[rows[0]]).astype(jnp.int32) for f in res.particles))
    want = np.asarray(jm.observation_log_prob(E_c, E_k, t, hist))
    got = tm.observation_log_prob(
        torch.from_numpy(np.array(E_c)), torch.from_numpy(np.array(E_k)), t,
        tm.State(*(torch.from_numpy(np.array(f)) for f in hist)),
    ).numpy()
    live = np.asarray(hist.r_c) >= 0
    np.testing.assert_array_equal(got[live], want[live])


def test_backward_logits_and_draws_match_jax(jax_history):
    """_backward_logits with history_layout=True on every row of a JAX
    filter history, allclose 1e-12; then the whole backward simulation fed
    the Gumbel noise that jax.random.categorical draws from the JAX keys
    samples the same trajectories."""
    params, E_c, E_k, res = jax_history
    tp = _port_params(params)
    R, B = params.n_regimes, 9
    T, N = res.log_weights.shape
    lw = np.array(res.log_weights)
    hist = [np.array(f) for f in res.particles]
    rng = np.random.default_rng(8)
    nxt_fields, _ = _random_ancestors(rng, R, B, dead_frac=0.0, d_hi=60)
    nxt_fields = [np.maximum(f, 1) if i in (1, 3) else f for i, f in enumerate(nxt_fields)]
    jn = jm.State(*(jnp.asarray(f) for f in nxt_fields))
    tn = tm.State(*(torch.from_numpy(f)[None] for f in nxt_fields))
    j_logits = jax.jit(lambda c, l: j_backward_logits(params, c, jn, l, history_layout=True))
    for t in range(T):
        jc = jm.State(*(jnp.asarray(f[t]) for f in hist))
        tc = tm.State(*(torch.from_numpy(f[t])[None] for f in hist))
        want = np.asarray(j_logits(jc, jnp.asarray(lw[t])))
        got = t_backward_logits(tp, tc, tn, torch.from_numpy(lw[t])[None], history_layout=True)[0].numpy()
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want), err_msg=f"row {t}")
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12, atol=1e-12, err_msg=f"row {t}")

    key = jax.random.PRNGKey(5)
    want = np.asarray(j_backward(key, params, res.log_weights, res.particles, B))
    key, k_last = jax.random.split(key)
    keys = jax.random.split(key, T)
    noise = {t: np.asarray(jax.random.gumbel(keys[t], (B, N), jnp.float64)) for t in range(T - 1)}
    noise[T - 1] = np.asarray(jax.random.gumbel(k_last, (B, N), jnp.float64))
    got = t_backward(
        tp, torch.from_numpy(lw)[None],
        tm.State(*(torch.from_numpy(f)[None] for f in hist)), B,
        noise=lambda t: torch.from_numpy(noise[t])[None],
    )
    assert got.shape == (1, T, B, 5) and got.dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_run_filter_log_z_matches_jax_when_nothing_resamples():
    """R=3 (I=15), M=2100, N=31,500, T=4: at most 9*15^(t-1) live children,
    so no step resamples and the filter is deterministic given the phantom
    regime. logZ equal to JAX's at rtol 1e-10; weights and particles of
    every history row equal (masks exact)."""
    R, T, M = 3, 4, 2100
    params = default_params(R=R, min_duration=2, d_max=32)
    tp = _port_params(params)
    rng = np.random.default_rng(12)
    n = rng.poisson(25, size=(T, 2)).astype(np.float64)
    y = np.minimum(rng.poisson(10, size=(T, 2)), n)
    E_c = np.asarray(j_emission(y, n, params.alpha, params.beta, dtype=jnp.float64))
    E_k = np.asarray(j_emission(np.minimum(y + 1, n), n, params.alpha, params.beta, dtype=jnp.float64))
    want = j_run_filter(jax.random.PRNGKey(0), params, jnp.asarray(E_c), jnp.asarray(E_k), M,
                        weight_dtype=jnp.float64, phantom_regime=1, unroll=1)
    got = t_run_filter(tp, torch.from_numpy(E_c), torch.from_numpy(E_k), M, n_units=2,
                       generator=torch.Generator().manual_seed(0), weight_dtype=F64, phantom_regime=1)
    assert got.log_weights.shape == (2, T, M * 15)
    for u in range(2):
        np.testing.assert_allclose(float(got.log_normalizing_constant[u]), float(want.log_normalizing_constant), rtol=1e-10)
        assert int(got.degenerate_steps[u]) == 0
        _assert_close_masked(got.log_weights[u].numpy(), want.log_weights, f"unit {u}")
        for a, b in zip(want.particles, got.particles):
            np.testing.assert_array_equal(b[u].numpy(), np.asarray(a))
            assert b.dtype == (torch.int32 if a.dtype == jnp.int32 else torch.int8)


def _exact_forward_backward(params, E_c, E_k, phantom_r, T):
    """Exact logZ and smoothing marginals on the enumerated state space: the
    oracle of tests/test_two_group_filter.py, with the JAX transition
    density jitted and the recursions in numpy."""
    R = params.n_regimes
    S = _enumerate_state_space(R, T)
    nS = len(S)
    trans = jax.jit(lambda p, n: jm.transition_log_prob(params, p, n))
    A = np.asarray(trans(jm.State(*(jnp.asarray(S[:, i])[:, None] for i in range(5))),
                         jm.State(*(jnp.asarray(S[:, i])[None, :] for i in range(5)))))
    obs = np.asarray(E_c)[:, S[:, 2]] + np.asarray(E_k)[:, S[:, 4]]
    init = np.asarray(jm.transition_log_prob(
        params, jm.phantom_state(phantom_r, (nS,)), jm.State(*(jnp.asarray(S[:, i]) for i in range(5))), step0=True))
    log_alpha = np.full((T, nS), -np.inf)
    log_alpha[0] = init + obs[0]
    for t in range(1, T):
        log_alpha[t] = logsumexp(log_alpha[t - 1][:, None] + A, axis=0) + obs[t]
    log_z = float(logsumexp(log_alpha[T - 1]))
    log_beta = np.zeros((T, nS))
    for t in range(T - 2, -1, -1):
        log_beta[t] = logsumexp(A + (obs[t + 1] + log_beta[t + 1])[None, :], axis=1)
    post = np.exp(log_alpha + log_beta - log_z)
    split = post[:, S[:, 0] == 0].sum(axis=1)
    ctrl = np.stack([post[:, S[:, 2] == r].sum(axis=1) for r in range(R)], -1)
    case = np.stack([post[:, S[:, 4] == r].sum(axis=1) for r in range(R)], -1)
    return log_z, split, ctrl, case


def test_filter_and_backward_match_exact_inference():
    """logZ and the split/regime marginals against exact forward-backward
    enumeration (the oracle of tests/test_two_group_filter.py), atol 0.05,
    with the resampler in the loop (M=60, T=10, B=4000)."""
    T, R = 10, 3
    params = default_params(R=R, min_duration=2, d_max=32)
    tp = _port_params(params)
    rng = np.random.default_rng(11)
    n_c = rng.poisson(25, size=(T, 1)).astype(np.float64)
    n_k = rng.poisson(25, size=(T, 1)).astype(np.float64)
    y_c = np.minimum(rng.poisson(10, size=(T, 1)), n_c)
    y_k = np.minimum(rng.poisson(10, size=(T, 1)), n_k)
    E_c = j_emission(y_c, n_c, params.alpha, params.beta, dtype=jnp.float64)
    E_k = j_emission(y_k, n_k, params.alpha, params.beta, dtype=jnp.float64)
    log_z, split, ctrl, case = _exact_forward_backward(params, E_c, E_k, 1, T)

    gen = torch.Generator().manual_seed(0)
    res = t_run_filter(tp, torch.from_numpy(np.asarray(E_c)), torch.from_numpy(np.asarray(E_k)), 60,
                       n_units=1, generator=gen, weight_dtype=F64, phantom_regime=1)
    np.testing.assert_allclose(res.log_normalizing_constant.numpy(), log_z, rtol=0, atol=0.05)
    traj = t_backward(tp, res.log_weights, res.particles, 4000, generator=gen)
    split_pf, regime_pf = t_functionals(traj, R)
    np.testing.assert_allclose(split_pf[0].numpy(), split, atol=0.05)
    np.testing.assert_allclose(regime_pf[0, :, :R].numpy(), ctrl, atol=0.05)
    np.testing.assert_allclose(regime_pf[0, :, R:].numpy(), case, atol=0.05)


def test_run_filter_without_history_runs_the_same_realisation():
    """return_history=False keeps only the final site of the same run."""
    R, T, M = 4, 25, 6
    params = default_params(R=R, min_duration=2, d_max=64)
    tp = _port_params(params)
    rng = np.random.default_rng(21)
    n = rng.poisson(25, size=(T, 2)).astype(np.float64)
    y = np.minimum(rng.poisson(10, size=(T, 2)), n)
    E = torch.from_numpy(np.asarray(j_emission(y, n, params.alpha, params.beta, dtype=jnp.float64)))
    run = lambda history: t_run_filter(tp, E, E, M, n_units=3, generator=torch.Generator().manual_seed(4),
                                       weight_dtype=F64, return_history=history)
    full, last = run(True), run(False)
    assert last.log_weights.shape == (3, M * 24)
    assert torch.equal(last.log_weights, full.log_weights[:, -1])
    for a, b in zip(last.particles, full.particles):
        assert torch.equal(a, b[:, -1].to(torch.int32))
    assert torch.equal(last.log_normalizing_constant, full.log_normalizing_constant)
    assert torch.equal(last.degenerate_steps, full.degenerate_steps)
