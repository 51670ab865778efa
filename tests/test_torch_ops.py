"""The port's numerics (hygeia_tpu_torch.ops, make_params) against the JAX
package's on the same inputs, made with numpy from a seed.

Tolerances: f64 log-densities rtol 1e-12 plus atol 1e-12 (XLA's and libm's
lgamma differ in the last bits, and a log-pmf near 0 is a sum of nine
lgamma terms of size ~100 that cancel); make_params rtol 1e-10 (the hazard
table divides two such values through exp). In float32 bit for bit: XLA's
CPU exp, log, log1p, lgamma, digamma and sin and its sum order
(ops/xla_f32.py), the BetaBinomial and robust emission tables and the
two-group hazard table rho (JAX's eager float32 tables).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.scipy.special import digamma as j_digamma, gammaln as j_gammaln

from hygeia_tpu.ops import distributions as jd
from hygeia_tpu.ops import hazard as jh
from hygeia_tpu.ops.emissions import emission_log_prob_table as j_emission
from hygeia_tpu.ops.emissions import robust_emission_log_prob_table as j_robust
from hygeia_tpu.ops.hazard import rho_two_group as j_rho
from hygeia_tpu.two_group.model import make_params as j_make_params
from hygeia_tpu_torch.ops import distributions as td
from hygeia_tpu_torch.ops import hazard as th
from hygeia_tpu_torch.ops import xla_f32
from hygeia_tpu_torch.ops.emissions import emission_log_prob_table as t_emission
from hygeia_tpu_torch.ops.emissions import robust_emission_log_prob_table as t_robust
from hygeia_tpu_torch.ops.hazard import gather_rho, rho_two_group as t_rho
from hygeia_tpu_torch.two_group.model import make_params as t_make_params

# The tensors here are small: one intra-op thread per test worker keeps the
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

F64 = torch.float64


def _t(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def test_distributions_match_jax_f64():
    rng = np.random.default_rng(0)
    n = rng.integers(0, 60, 500).astype(np.float64)
    x = np.floor(rng.uniform(0, 1, 500) * (n + 3)) - 1  # includes x < 0 and x > n
    a = rng.uniform(0.2, 30, 500)
    b = rng.uniform(0.2, 30, 500)
    want = np.asarray(jd.beta_binomial_log_pmf(jnp.asarray(x), jnp.asarray(n), jnp.asarray(a), jnp.asarray(b)))
    got = td.beta_binomial_log_pmf(_t(x), _t(n), _t(a), _t(b)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12, atol=1e-12)

    k = np.concatenate([rng.integers(0, 400, 300), [-1, 0, 0]]).astype(np.float64)
    size = rng.uniform(0.5, 5, 303)
    prob = np.concatenate([rng.uniform(0.01, 0.99, 300), [0.5, 0.0, 0.0]])
    k[-1] = 3.0  # prob == 0 at x > 0 -> -inf; x == 0 -> 0
    want = np.asarray(jd.neg_binomial_log_pmf(jnp.asarray(k), jnp.asarray(size), jnp.asarray(prob)))
    got = td.neg_binomial_log_pmf(_t(k), _t(size), _t(prob)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12, atol=1e-12)

    mu = rng.uniform(0.05, 0.95, 6)
    sigma = rng.uniform(0.01, 0.1, 6)
    for g, w in zip(td.mu_sigma_to_alpha_beta(_t(mu), _t(sigma)), jd.mu_sigma_to_alpha_beta(jnp.asarray(mu), jnp.asarray(sigma))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)
    z = rng.normal(size=50) * 4
    np.testing.assert_allclose(td.inv_logit(_t(z)).numpy(), np.asarray(jd.inv_logit(jnp.asarray(z))), rtol=1e-12)
    p = rng.uniform(0.01, 0.99, 50)
    np.testing.assert_allclose(td.logit(_t(p)).numpy(), np.asarray(jd.logit(jnp.asarray(p))), rtol=1e-12)


def test_emission_table_matches_jax_f64():
    rng = np.random.default_rng(1)
    T, S, R = 300, 3, 6
    n = rng.poisson(20, size=(T, S)).astype(np.float64)
    n[::17] = 0  # all-missing sites contribute 0
    y = np.minimum(rng.poisson(9, size=(T, S)), n)
    alpha = rng.uniform(0.5, 40, R)
    beta = rng.uniform(0.5, 40, R)
    want = np.asarray(j_emission(y, n, jnp.asarray(alpha), jnp.asarray(beta), dtype=jnp.float64))
    got = t_emission(y, n, _t(alpha), _t(beta), dtype=F64).numpy()
    assert got.shape == (T, R)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _param_kwargs(R, seed):
    rng = np.random.default_rng(seed)
    logp = np.where(np.eye(R, dtype=bool), -np.inf, rng.normal(size=(R, R)))
    return dict(
        mu=np.linspace(0.1, 0.9, R),
        sigma=np.full(R, 0.08),
        p_softmax_control=logp,
        omega_logit_control=rng.normal(size=R),
        omega_case=0.8,
        kappa_control=np.full(R, 2.0),
        kappa_case=np.full(R, 2.0),
        merge_log_prob=np.log(0.1),
        split_prob=0.01,
        minimum_duration=3,
        d_max=96,
    )


def test_make_params_matches_jax_f64():
    kw = _param_kwargs(6, 5)
    want = j_make_params(**kw, dtype=jnp.float64)
    got = t_make_params(**kw, dtype=F64, device="cpu")
    assert got.n_regimes == want.n_regimes and got.min_duration == want.min_duration
    for name in ("mu", "sigma", "alpha", "beta", "log_p_control", "log_p_merged", "rho_control", "rho_case"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == np.float64 and g.shape == w.shape, name
        np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w), err_msg=name)
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-10, err_msg=name)


def _first_guard_column(rho):
    hit = rho == np.float32(0.1)
    return np.where(hit.any(axis=1), hit.argmax(axis=1), -1)


@pytest.mark.parametrize("kappa,u", [(2.0, 3), (2.0, 2), (1.3, 5), (3.7, 1)])
def test_f32_hazard_table_keeps_jax_guard_onset(kappa, u):
    """At f32 the survival function underflows in the deep tail and the 0.1
    guard takes over; the port's table is JAX's eager f32 table bit for bit
    (XLA's Lentz loop, its FMAs and flush-to-zero replayed), so the guard
    switches at the JAX table's column, for the six omega of the two-group
    and single-group defaults, d_max 4096."""
    omega = np.array([0.8, 1 / (1 + np.exp(-2.0)), 1 / (1 + np.exp(2.0)), 0.995, 0.975, 0.9], np.float32)
    kappa = np.full(6, kappa, np.float32)
    want = np.asarray(j_rho(jnp.asarray(kappa), jnp.asarray(omega), u, 4096))
    got = t_rho(torch.from_numpy(kappa), torch.from_numpy(omega), u, 4096).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    gw, gg = _first_guard_column(want), _first_guard_column(got)
    assert np.all(gw[:3] > 0), gw  # the f32 guard fires in the two-group rows
    np.testing.assert_array_equal(gg, gw)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


_DEFAULTS = {
    "infer": ([0.95, 0.05, 0.80, 0.20, 0.50, 0.50], [0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751]),
    "single_group": ([0.99, 0.01, 0.80, 0.20, 0.50, 0.50], [0.05, 0.05, 0.20, 0.20, 0.20, 0.2886751]),
}


def _f32_shapes(defaults):
    mu, sigma = (jnp.asarray(np.asarray(v, np.float32)) for v in _DEFAULTS[defaults])
    return tuple(np.asarray(v) for v in jd.mu_sigma_to_alpha_beta(mu, sigma))


def _counts(T, S, seed):
    rng = np.random.default_rng(seed)
    n = rng.poisson(20, size=(T, S)).astype(np.float32)
    n[::13] = 0
    return np.minimum(rng.poisson(10, size=(T, S)), n).astype(np.float32), n


@pytest.mark.parametrize("S", [2, 8, 37])
@pytest.mark.parametrize("defaults", ["infer", "single_group"])
def test_f32_emission_table_is_jax_bit_for_bit(defaults, S):
    """The f32 BetaBinomial table equals JAX's eager f32 table bit for bit
    at the infer and the single-group defaults (shapes down to 0.0296, the
    lgamma reflection branch), over 2, 8 and 37 samples (the sum over
    samples in XLA's order, windows of 32 past 32)."""
    alpha, beta = _f32_shapes(defaults)
    y, n = _counts(3000, S, S)
    want = np.asarray(j_emission(y, n, jnp.asarray(alpha), jnp.asarray(beta), dtype=jnp.float32))
    got = t_emission(y, n, torch.from_numpy(alpha), torch.from_numpy(beta)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("defaults", ["infer", "single_group"])
def test_f32_robust_table_is_jax_bit_for_bit(defaults):
    """The f32 robust table equals JAX's eager f32 table bit for bit, and
    is the same at any chunk size."""
    alpha, beta = _f32_shapes(defaults)
    y, n = _counts(150, 3, 5)
    want = np.asarray(j_robust(y, n, jnp.asarray(alpha), jnp.asarray(beta), 0.05, dtype=jnp.float32))
    got = t_robust(y, n, torch.from_numpy(alpha), torch.from_numpy(beta), 0.05).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    chunked = t_robust(y, n, torch.from_numpy(alpha), torch.from_numpy(beta), 0.05, chunk_elements=4000)
    assert torch.equal(chunked, torch.from_numpy(got))


def test_xla_f32_sin_and_reduce_sum_are_jax_cpu_bit_for_bit():
    """sin (glibc's sinf, which XLA's CPU sine calls) on [0, pi/2], and
    reduce_sum against jnp.sum along the first, middle and last axis at
    lengths around XLA's 32-element windows."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(0, np.pi / 2, 50000), np.linspace(0, np.pi / 2, 20001),
                        np.float32(2.0) ** -np.arange(1, 40)]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.sin)(jnp.asarray(x)))
    np.testing.assert_array_equal(xla_f32.sin(torch.from_numpy(x)).numpy().view(np.int32), want.view(np.int32))
    for n in (1, 2, 31, 32, 33, 37, 64, 65, 100, 1100):
        a = rng.normal(size=(3, n, 4)).astype(np.float32)
        for axis in (0, 1, 2):
            b = np.moveaxis(a, 1, axis)
            want = np.asarray(jax.jit(lambda v: jnp.sum(v, axis=axis))(jnp.asarray(b)))
            got = xla_f32.reduce_sum(torch.from_numpy(np.ascontiguousarray(b)), axis).numpy()
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=f"n={n} axis={axis}")


@pytest.mark.parametrize("dead_regime", [-1, 0])
def test_gather_rho_clamps_sojourn_and_regime(dead_regime):
    table = torch.arange(12, dtype=F64).reshape(3, 4)
    d = torch.tensor([1, 4, 9, 0])
    r = torch.tensor([2, 1, 0, dead_regime])
    got = gather_rho(table, d, r)
    assert got.tolist()[:3] == [8.0, 7.0, 3.0]
    assert got[3].item() == 0.0  # clamped to [0, 0]


def test_row_softmax_offdiag_matches_jax_f64():
    R = 6
    theta = np.random.default_rng(4).normal(size=(3, R * (R - 1))) * 3
    got = td.row_softmax_offdiag(_t(theta), R)
    assert got.shape == (3, R, R)
    for i in range(3):
        want = np.asarray(jd.row_softmax_offdiag(jnp.asarray(theta[i]), R))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-12, atol=1e-300)
        assert np.all(np.diag(got[i].numpy()) == 0)


@pytest.mark.parametrize("n", [1, 16, 17, 64, 100, 1000, 4096, 4097])
def test_exclusive_cumsum_is_the_xla_cpu_order(n):
    """Bit for bit JAX's f32 sum on the CPU: XLA's blocked base-16 scan."""
    x = np.random.default_rng(n).exponential(size=(6, n)).astype(np.float32) * 1e-3
    want = np.asarray(jh._exclusive_cumsum(jnp.asarray(x)))
    got = th._exclusive_cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("u", [1, 2, 3])
def test_hazard_table_matches_jax_f64(u):
    """(rho, exit_status) at depth 32, where the survival stays far from 0
    (see test_torch_single_group.py): rho rtol 1e-12, the latch equal."""
    rng = np.random.default_rng(u)
    kappa, omega = rng.uniform(1.5, 3.0, 4), rng.uniform(0.85, 0.99, 4)
    want_rho, want_exit = jh.hazard_table(jnp.asarray(kappa), jnp.asarray(omega), u, 32)
    got_rho, got_exit = th.hazard_table(_t(kappa), _t(omega), u, 32)
    assert got_rho.dtype == F64
    np.testing.assert_array_equal(got_exit.numpy(), np.asarray(want_exit))
    np.testing.assert_allclose(got_rho.numpy(), np.asarray(want_rho), rtol=1e-12, atol=1e-300)


def test_exclusive_cumsum_reproduces_the_jax_latch_from_jax_addends():
    """Given JAX's own f32 pmf at the CLI defaults (kappa 2, u 2, omega as
    given, d_max 4096), the port's sum latches where JAX's does: 3728 and
    736, none in the other four regimes. (The port's own addends differ:
    ROADMAP.md section 3.)"""
    omega = np.array([0.995, 0.975, 0.95, 0.925, 0.9, 0.9], np.float32)
    d = jnp.arange(1, 4097, dtype=jnp.float32)[None, :]
    k, o = jnp.full((6, 1), 2.0, jnp.float32), jnp.asarray(omega)[:, None]
    little_h = jnp.where(d >= 2, jnp.exp(jd.neg_binomial_log_pmf(jnp.maximum(d - 2, 0.0), k, o)), 0.0)
    got = th._exclusive_cumsum(torch.from_numpy(np.asarray(little_h))).numpy()
    np.testing.assert_array_equal(got, np.asarray(jh._exclusive_cumsum(little_h)))
    latched = got >= 1.0
    onsets = [int(r.argmax()) if r.any() else -1 for r in latched]
    assert onsets == [3728, 736, -1, -1, -1, -1]


def test_ieee_elementary_functions_match_libm():
    """_exp64, _log64 and _log1p64 (built from exactly rounded operations,
    so every device gives the same bits) within 2 ulp of numpy's libm, with
    its special values."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=20000) * 300, [0.0, -0.0, 709.7, -745.0, -750.0, 710.0]])
    got = th._exp64(_t(x)).numpy()
    np.testing.assert_allclose(got, np.exp(x), rtol=4.5e-16, atol=0)
    y = np.concatenate([np.exp(rng.normal(size=20000) * 200), [5e-324, 2.2e-308, 1.0, 2.0, 1e308]])
    np.testing.assert_allclose(th._log64(_t(y)).numpy(), np.log(y), rtol=4.5e-16, atol=1e-300)
    z = np.concatenate([rng.uniform(-0.999, 5, 20000), 10.0 ** rng.uniform(-300, -1, 2000), [0.0, -0.5]])
    np.testing.assert_allclose(th._log1p64(_t(z)).numpy(), np.log1p(z), rtol=4.5e-16, atol=0)
    assert th._log64(_t([0.0, 1.0, np.inf])).tolist() == [-np.inf, 0.0, np.inf]
    assert np.isnan(th._log64(_t([-1.0, np.nan])).numpy()).all()
    assert th._exp64(_t([-np.inf, np.inf])).tolist() == [0.0, np.inf]
    assert th._log1p64(_t([-1.0])).tolist() == [-np.inf]


def _table_inputs():
    """The float32 arguments the single-group tables hand each function:
    d + kappa, kappa and d + 1 for d < 4096 at kappa 2 and at seeded free
    kappa; omega and -omega over the seeded range; the log-pmf values; and
    the logits that make omega and kappa."""
    rng = np.random.default_rng(7)
    logit_om = np.concatenate([np.log(0.99 / 0.01) + np.array([0.0]),
                               rng.normal(scale=0.5, size=600) + rng.uniform(1.5, 5.5, 600)])
    log_kap = np.concatenate([[np.log(2.0)], np.log(2.0) + rng.normal(scale=0.5, size=60)])
    om = np.asarray(jd.inv_logit(jnp.asarray(logit_om, jnp.float32)))
    kap = np.asarray(jnp.exp(jnp.asarray(log_kap, jnp.float32)))
    d = np.arange(4096, dtype=np.float32)
    lg_args = np.concatenate([(d[None, :] + kap[:, None]).ravel(), kap, d + 1.0])
    lp = np.asarray(jd.neg_binomial_log_pmf(jnp.asarray(d[None, :]), jnp.asarray(kap[:8, None]),
                                            jnp.asarray(om[::75, None])[:, None]))
    exp_args = np.concatenate([lp[np.isfinite(lp)], -logit_om, log_kap,
                               rng.normal(size=20000) * 40]).astype(np.float32)
    broad = np.exp(rng.normal(size=20000) * 20).astype(np.float32)
    return {
        "exp": exp_args,
        "log": np.concatenate([om, broad, [0.0, np.inf, -1.0]]).astype(np.float32),
        "log1p": np.concatenate([-om, 1 / (1 + np.exp(-logit_om)) - 1, rng.uniform(-0.99, 3, 20000)]
                                ).astype(np.float32),
        "lgamma": np.concatenate([lg_args, rng.uniform(0.5, 1e4, 20000)]).astype(np.float32),
        "digamma": np.concatenate([lg_args, rng.uniform(0.5, 1e4, 20000)]).astype(np.float32),
    }


@pytest.mark.parametrize("name, jax_fn", [("exp", jnp.exp), ("log", jnp.log), ("log1p", jnp.log1p),
                                          ("lgamma", j_gammaln), ("digamma", j_digamma)])
def test_xla_f32_functions_are_jax_cpu_bit_for_bit(name, jax_fn):
    """ops/xla_f32.py replays XLA's CPU float32 kernels (FMA contractions
    included): the same bits as jnp's on every input the tables use."""
    x = _table_inputs()[name]
    want = np.asarray(jax.jit(jax_fn)(jnp.asarray(x)))
    got = getattr(xla_f32, name)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    same = (got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), (x[~same][:5], got[~same][:5], want[~same][:5])
