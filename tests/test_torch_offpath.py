"""The port's off-main-path numerics against the JAX package's, with
tests/test_offpath.py's oracles: the discrete-normal family at float64
(rtol 1e-12, over the tails and the guards), the safeguarded Newton root
finder (the same iterates) and the conditional resamplers (the same
parents and distinguished index given the same uniforms)."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hygeia_tpu.ops import discrete_normal as jdn
from hygeia_tpu.ops import resampling as jrs
from hygeia_tpu.ops.newton import safeguarded_newton as jax_newton
from hygeia_tpu_torch.ops import discrete_normal as tdn
from hygeia_tpu_torch.ops import resampling as trs
from hygeia_tpu_torch.ops.newton import safeguarded_newton
from tests.test_offpath import _conditional_systematic_reference, _newton_reference

torch.set_num_threads(1)

# Every public function of the family, with the truncation bounds it takes.
_BOUNDS = {"log_diff_cdfs": None, "right": (6,), "left": (1,), "truncated": (0, 8)}
_FUNCS = sorted(n for n in dir(jdn) if n.startswith(("log_", "grad_")))


def _bounds(name):
    if name == "log_diff_cdfs":
        return "diff"
    for key in ("right", "left"):
        if key in name:
            return _BOUNDS[key]
    return _BOUNDS["truncated"] if "truncated" in name else ()


def _assert_close(got, want, what):
    """Equal, or within rtol 1e-12; the same non-finite values."""
    same = (got == want) | np.isclose(got, want, rtol=1e-12, atol=0) | (np.isnan(got) & np.isnan(want))
    assert same.all(), (what, np.flatnonzero(~same)[:5], got[~same][:5], want[~same][:5])


def test_ndtr_and_log_ndtr_equal_jax():
    """Phi and log Phi for |z| < 37 (beyond, Phi is below 1e-300 and XLA's
    CPU flushes subnormal results to zero where torch keeps them)."""
    from jax.scipy.special import log_ndtr, ndtr

    z = np.concatenate([np.linspace(-37, 37, 74_001), -np.logspace(-3, 1.55, 500), np.logspace(-3, 1.55, 500)])
    _assert_close(tdn.ndtr(torch.from_numpy(z)).numpy(), np.asarray(ndtr(jnp.asarray(z))), "ndtr")
    _assert_close(tdn.log_ndtr(torch.from_numpy(z)).numpy(), np.asarray(log_ndtr(jnp.asarray(z))), "log_ndtr")


@pytest.mark.parametrize("mean,sd", [(2.3, 1.7), (0.0, 1.0), (-3.0, 0.4), (10.0, 3.0), (0.5, 0.05)])
@pytest.mark.parametrize("name", _FUNCS)
def test_discrete_normal_equals_jax(name, mean, sd):
    """Every function over integers from the deep lower tail to the deep
    upper one (the survival-function fallbacks, the isfinite-else-0 guards
    and the out-of-support values included), while Phi's differences stay
    above the subnormal range (|z| < 37)."""
    xs = np.arange(-60, 70).astype(np.float64)
    xs = xs[np.abs((xs - mean) / sd) < 36]
    bounds = _bounds(name)
    jf, tf = getattr(jdn, name), getattr(tdn, name)
    assert len(inspect.signature(jf).parameters) == len(inspect.signature(tf).parameters)
    if bounds == "diff":
        args_j, args_t = (jnp.asarray(xs), jnp.asarray(xs - 3)), (torch.from_numpy(xs), torch.from_numpy(xs - 3))
    else:
        args_j, args_t = (jnp.asarray(xs), *bounds), (torch.from_numpy(xs), *bounds)
    want = np.asarray(jf(*args_j, mean, sd))
    got = tf(*args_t, mean, sd).numpy()
    _assert_close(got, want, name)
    if name.startswith("log_density"):
        assert np.isfinite(got).any()


def test_discrete_normal_scalar_guards_equal_jax():
    for name, args in (("log_density_left_truncated", (0, 1)), ("log_density_right_truncated", (7, 6)),
                       ("log_density_truncated", (9, 0, 8)), ("grad_mean_log_density_left_truncated", (0, 1)),
                       ("grad_sd_log_density_right_truncated", (7, 6)), ("grad_var_log_density_truncated", (-1, 0, 8)),
                       ("log_density", (20,)), ("log_density", (20.0,))):
        want = float(getattr(jdn, name)(*args, 0.0 if name == "log_density" else 2.3,
                                        1.0 if name == "log_density" else 1.7))
        got = float(getattr(tdn, name)(*args, 0.0 if name == "log_density" else 2.3,
                                       1.0 if name == "log_density" else 1.7))
        assert got == want or np.isclose(got, want, rtol=1e-12), (name, got, want)


_NEWTON = [
    (lambda x: x * x - 2.0, lambda x: 2.0 * x, 0.0, 2.0),
    ("cos", None, 0.0, 1.5),
    # f'(x) tiny near lb: Newton steps overshoot, the bisection safeguard engages.
    (lambda x: x**3 - 2.0 * x + 2.0, lambda x: 3.0 * x * x - 2.0, -3.0, 0.0),
    # not bracketing: x = lb returned untouched
    (lambda x: x * x - 2.0, lambda x: 2.0 * x, 2.0, 3.0),
]


@pytest.mark.parametrize("case", range(len(_NEWTON)))
def test_newton_equals_jax_and_the_reference_port(case):
    f, f1, lb, ub = _NEWTON[case]
    if f == "cos":
        fj, f1j = (lambda x: jnp.cos(x) - x), (lambda x: -jnp.sin(x) - 1.0)
        ft, f1t = (lambda x: torch.cos(x) - x), (lambda x: -torch.sin(x) - 1.0)
        fr, f1r = (lambda x: float(np.cos(x) - x)), (lambda x: float(-np.sin(x) - 1.0))
    else:
        fj = ft = f
        f1j = f1t = f1
        fr, f1r = (lambda v: float(f(v))), (lambda v: float(f1(v)))
    x, ok = safeguarded_newton(ft, f1t, lb, ub, tol_x=1e-12, tol_f=1e-12, n_iterations=100)
    xj, okj = jax_newton(fj, f1j, lb, ub, tol_x=1e-12, tol_f=1e-12, n_iterations=100)
    xr, okr = _newton_reference(fr, f1r, lb, ub, 1e-12, 1e-12, 100)
    assert bool(ok) == bool(okj) == okr
    # The reference's loop exactly; JAX's within rtol 1e-12 (XLA compiles the
    # loop body and contracts f's multiplies and adds into FMAs).
    assert x.dtype == torch.float64 and float(x) == xr
    np.testing.assert_allclose(float(x), float(xj), rtol=1e-12, atol=0)
    if not okr:
        assert float(x) == lb


def test_newton_stops_at_the_iteration_budget():
    """n_iterations caps the steps: two steps give the reference loop's
    second iterate (and the JAX package's, within rtol 1e-12)."""
    f, f1 = (lambda x: x**3 - 2.0 * x + 2.0), (lambda x: 3.0 * x * x - 2.0)
    x, _ = safeguarded_newton(f, f1, -3.0, 0.0, n_iterations=2)
    xj, _ = jax_newton(f, f1, -3.0, 0.0, n_iterations=2)
    xr, _ = _newton_reference(lambda v: float(f(v)), lambda v: float(f1(v)), -3.0, 0.0, 1e-12, 1e-12, 2)
    assert float(x) == xr and abs(float(x) + 1.7692923542386314) > 1e-6
    np.testing.assert_allclose(float(x), float(xj), rtol=1e-12, atol=0)


def test_conditional_systematic_equals_jax_and_the_reference_port():
    """200 random weight vectors, conditioning parents and uniform pairs
    against the reference port, the first 20 against the JAX package too
    (its eager call compiles anew for every length)."""
    rng = np.random.default_rng(7)
    for trial in range(200):
        n = int(rng.integers(2, 40))
        w = rng.dirichlet(np.full(n, 0.4))
        a = int(rng.integers(0, n))
        if w[a] < 1e-12:
            continue
        u, u_strat = float(rng.uniform()), float(rng.uniform())
        ref_parents, ref_b = _conditional_systematic_reference(u, u_strat, w, n, a)
        got = trs.conditional_systematic_resampling(
            torch.log(torch.from_numpy(w))[None], n, torch.tensor([a]),
            torch.tensor([u], dtype=torch.float64), torch.tensor([u_strat], dtype=torch.float64))
        assert got.parent_indices.dtype == torch.int32 and got.b.dtype == torch.int32
        assert int(got.b[0]) == ref_b and np.array_equal(got.parent_indices[0].numpy(), ref_parents), trial
        if trial < 20:
            want = jrs.conditional_systematic_resampling(None, jnp.log(jnp.asarray(w)), n, a, uniforms=(u, u_strat))
            assert int(got.b[0]) == int(want.b), trial
            assert np.array_equal(got.parent_indices[0].numpy(), np.asarray(want.parent_indices)), trial


def test_conditional_systematic_batched_equals_its_units():
    rng = np.random.default_rng(3)
    U, n = 16, 30
    w = rng.dirichlet(np.full(n, 0.5), size=U)
    a = rng.integers(0, n, size=U)
    u, us = rng.uniform(size=U), rng.uniform(size=U)
    lw = torch.log(torch.from_numpy(w))
    batched = trs.conditional_systematic_resampling(lw, n, torch.from_numpy(a), torch.from_numpy(u), torch.from_numpy(us))
    for i in range(U):
        one = trs.conditional_systematic_resampling(lw[i : i + 1], n, torch.tensor([a[i]]), torch.from_numpy(u[i : i + 1]),
                                                    torch.from_numpy(us[i : i + 1]))
        assert torch.equal(one.parent_indices[0], batched.parent_indices[i]) and int(one.b[0]) == int(batched.b[i])
        assert int(batched.parent_indices[i, batched.b[i]]) == a[i]


@pytest.mark.parametrize("normalized", [False, True])
def test_conditional_multinomial_equals_jax_given_its_uniforms(normalized):
    """JAX's draws are inverse-CDF picks of M uniforms (the key's
    ``jax.random.uniform``); given those uniforms the port picks the same
    parents and pins b = 0 to the conditioning parent."""
    import jax

    w = np.array([0.4, 0.3, 0.2, 0.1])
    key = jax.random.PRNGKey(3)
    lw = jnp.log(jnp.asarray(w))
    want = jrs.conditional_multinomial_resampling(key, lw, 6, 2, normalized=normalized)
    uniforms = np.array(jax.random.uniform(key, (6,), dtype=jnp.float32))
    got = trs.conditional_multinomial_resampling(torch.log(torch.from_numpy(w))[None], 6, torch.tensor([2]),
                                                 torch.from_numpy(uniforms)[None], normalized=normalized)
    assert np.array_equal(got.parent_indices[0].numpy(), np.asarray(want.parent_indices))
    assert int(got.b[0]) == int(want.b) == 0 and int(got.parent_indices[0, 0]) == 2
