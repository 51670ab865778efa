"""The port's marginal filter (hygeia_tpu_torch.two_group.marginal) and
``infer --marginal`` against the JAX package's and against exact
inference, on inputs made with numpy from a seed.

Tolerances: smoothing marginals and logZ against exact forward-backward
atol 0.05 (the bound of tests/test_marginal_filter.py); the compact psi
update against JAX's at f64 rtol 1e-12 (the same products and sums in
another order); the structured update against the generic one over the
full backward kernel at f64 rtol 1e-10 on live children (the JAX test's
own comparison, run at f32 there); the regime marginals sum to 1 within
1e-6 (psi is float32).
"""

import gzip
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hygeia_tpu.ops.emissions import emission_log_prob_table as j_emission
from hygeia_tpu.two_group import model as jm
from hygeia_tpu.two_group.filter import _first_step as j_first_step, _one_step as j_one_step
from hygeia_tpu.two_group.marginal import _structured_psi_update_compact as j_compact
from hygeia_tpu.two_group.proposal import num_children
from hygeia_tpu.two_group.runner import infer_segment as jax_infer_segment
from hygeia_tpu_torch import cli as torch_cli
from hygeia_tpu_torch.two_group import marginal as tmarg
from hygeia_tpu_torch.two_group.filter import _one_step
from hygeia_tpu_torch.two_group.model import State
from tests.test_torch_streaming import BB, MM, MU, SIGMA, _write_chromosome
from tests.test_torch_two_group import _exact_forward_backward, _port_params, jax_history  # noqa: F401
from tests.test_two_group_model import default_params

torch.set_num_threads(1)

F64 = torch.float64


def _tables(params, T, S, seed, case_shift=1):
    rng = np.random.default_rng(seed)
    n = rng.poisson(25, size=(T, S)).astype(np.float64)
    y = np.minimum(rng.poisson(10, size=(T, S)), n)
    E_c = np.asarray(j_emission(y, n, params.alpha, params.beta, dtype=jnp.float64))
    E_k = np.asarray(j_emission(np.minimum(y + case_shift, n), n, params.alpha, params.beta, dtype=jnp.float64))
    return E_c, E_k


def test_marginal_filter_matches_exact():
    """Two units of T=10, R=3, M=60 with epsilon -> 0 (every time finalised
    at the last site): logZ and every smoothing marginal within 0.05 of
    exact forward-backward for the same phantom regime; no spill."""
    T, R = 10, 3
    params = default_params(R=R, min_duration=2, d_max=32)
    E_c, E_k = _tables(params, T, 1, 21)
    log_z, split, ctrl, case = _exact_forward_backward(params, E_c, E_k, 1, T)
    res = tmarg.run_marginal_filter(
        _port_params(params), torch.from_numpy(E_c), torch.from_numpy(E_k), 60, n_units=2,
        generator=torch.Generator().manual_seed(0), epsilon=1e-12, smoothing_window=16,
        weight_dtype=F64, phantom_regime=1)
    assert bool(res.valid.all()) and res.spill_count.tolist() == [0, 0]
    assert res.degenerate_steps.tolist() == [0, 0]
    for u in range(2):
        f = res.functionals[u].numpy()
        np.testing.assert_allclose(float(res.log_normalizing_constant[u]), log_z, atol=0.05)
        np.testing.assert_allclose(f[:, 0], split, atol=0.05)
        np.testing.assert_allclose(f[:, 1:1 + R], ctrl, atol=0.05)
        np.testing.assert_allclose(f[:, 1 + R:], case, atol=0.05)


def test_marginal_filter_runs_the_filters_realisation():
    """With the same generator the marginal filter draws what run_filter
    draws (phantom regimes, then each site's uniforms): the same logZ bit
    for bit, over three units at f32."""
    from hygeia_tpu_torch.two_group.filter import run_filter

    T, R, M = 30, 4, 8
    params = default_params(R=R, min_duration=2, d_max=64)
    E_c, E_k = _tables(params, T, 2, 13)
    tp = _port_params(params)
    args = (tp, torch.from_numpy(E_c), torch.from_numpy(E_k), M)
    want = run_filter(*args, n_units=3, generator=torch.Generator().manual_seed(6))
    got = tmarg.run_marginal_filter(*args, n_units=3, generator=torch.Generator().manual_seed(6))
    assert torch.equal(got.log_normalizing_constant, want.log_normalizing_constant)
    assert torch.equal(got.degenerate_steps, want.degenerate_steps)


def test_marginal_filter_default_epsilon_rows_consistent():
    """The default epsilon finalises times early: every time valid, the
    regime marginals of each group sum to 1, the split probability in [0, 1]."""
    T, R = 40, 3
    params = default_params(R=R, min_duration=2, d_max=64)
    E, _ = _tables(params, T, 2, 5)
    res = tmarg.run_marginal_filter(
        _port_params(params), torch.from_numpy(E), torch.from_numpy(E), 20, n_units=3,
        generator=torch.Generator().manual_seed(1), epsilon=0.01, smoothing_window=32, weight_dtype=F64)
    assert bool(res.valid.all())
    f = res.functionals.numpy()
    np.testing.assert_allclose(f[..., 1:1 + R].sum(-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(f[..., 1 + R:].sum(-1), 1.0, atol=1e-6)
    assert np.all((f[..., 0] >= -1e-9) & (f[..., 0] <= 1 + 1e-9))


def test_small_window_spills_and_injected_uniforms_repeat():
    """A window of 2 pending times with epsilon 0 must force-finalise
    (spills counted, every time still valid); the same injected uniforms
    give the same run bit for bit."""
    T, R, M = 12, 3, 6
    params = default_params(R=R, min_duration=2, d_max=32)
    E_c, E_k = _tables(params, T, 2, 8)
    tp = _port_params(params)
    g = torch.Generator().manual_seed(3)
    u = (torch.rand((2, T - 1), generator=g, dtype=F64).float(), torch.rand((2, T - 1, M), generator=g).float())
    run = lambda: tmarg.run_marginal_filter(
        tp, torch.from_numpy(E_c), torch.from_numpy(E_k), M, n_units=2, uniforms=u, epsilon=0.0,
        smoothing_window=2, weight_dtype=F64, phantom_regime=0)
    a, b = run(), run()
    assert torch.equal(a.functionals, b.functionals) and torch.equal(a.log_normalizing_constant, b.log_normalizing_constant)
    assert bool((a.spill_count > 0).all()) and torch.equal(a.spill_count, b.spill_count)
    assert bool(a.valid.all())


def _jax_steps(R, M, T, seed):
    """A JAX filter run at f64 kept step by step: (params, [(prev state,
    prev lw, new state, new lw, parents)])."""
    from jax.scipy.special import logsumexp as lse

    params = default_params(R=R, min_duration=2, d_max=64)
    E_c, E_k = _tables(params, T, 2, 3 + R, case_shift=3)
    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    N = M * num_children(R)
    lw, st = j_first_step(k0, params, E_c, E_k, N, jnp.float64)
    lw = lw - lse(lw)
    steps = []
    for t in range(1, T):
        new_lw, new_st, parents = j_one_step(jax.random.fold_in(key, t), params, E_c, E_k, t, lw, st, M,
                                             True, False, with_parents=True)
        steps.append((st, lw, new_st, new_lw, parents))
        lw, st = new_lw - lse(new_lw), new_st
    return params, steps


def _generic_psi_update(params, prev, new, lw_prev, psi):
    """psi (U, S, F, N) times the normalised backward kernel over the full
    (N_new, N_prev) grid, built from _backward_logits (the JAX test's
    generic path)."""
    from hygeia_tpu_torch.two_group.backward import _backward_logits

    logB = _backward_logits(params, prev, new, lw_prev, history_layout=True)
    logBZ = torch.logsumexp(logB, dim=-1, keepdim=True)
    B = torch.where(torch.isfinite(logBZ), torch.exp(logB - logBZ), 0.0).to(psi.dtype)
    return torch.einsum("usfj,unj->usfn", psi, B)


def _port_state(st):
    return State(*(torch.from_numpy(np.asarray(f).astype(np.int64))[None] for f in st))


@pytest.mark.parametrize("R,M,seed", [(4, 7, 5), (6, 5, 9)])
def test_compact_psi_update_matches_jax_f64(R, M, seed):
    """_structured_psi_update_compact on every step of a JAX filter run:
    the same prev particles, weights, ancestors and a random psi in both
    packages, rtol 1e-12 at f64."""
    params, steps = _jax_steps(R, M, 8, seed)
    tp = _port_params(params)
    rng = np.random.default_rng(seed)
    C = tmarg.num_compact_columns(R, M)
    for t, (st, lw, _new_st, _new_lw, parents) in enumerate(steps, start=1):
        psi = rng.uniform(size=(4, 1 + 2 * R, C))
        w = np.where(np.isfinite(lw), np.exp(np.asarray(lw)), 0.0)
        anc = jm.State(*(f[parents] for f in st))
        want = np.asarray(j_compact(params, st, jnp.asarray(w), anc, jnp.asarray(psi)))
        got = tmarg._structured_psi_update_compact(
            tp, _port_state(st), torch.from_numpy(w)[None], _port_state(anc), torch.from_numpy(psi)[None])
        np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-12, atol=1e-14, err_msg=f"t={t}")


@pytest.mark.parametrize("R,M,seed", [(4, 7, 5), (6, 5, 9)])
def test_structured_psi_update_matches_generic(R, M, seed):
    """The structured update (no (N, N) grid) against psi times the full
    normalised backward kernel built from _backward_logits, on every live
    child of every step, at f64."""
    params, steps = _jax_steps(R, M, 12, seed)
    tp = _port_params(params)
    rng = np.random.default_rng(seed)
    N = M * num_children(R)
    for t, (st, lw, new_st, new_lw, parents) in enumerate(steps, start=1):
        psi = torch.from_numpy(rng.uniform(size=(1, 5, 1 + 2 * R, N)))
        prev, new = _port_state(st), _port_state(new_st)
        anc = State(*(f[:, torch.from_numpy(np.asarray(parents))] for f in prev))
        lw_t = torch.from_numpy(np.asarray(lw))[None]
        got = tmarg._structured_psi_update(tp, prev, lw_t, anc, psi)
        want = _generic_psi_update(tp, prev, new, lw_t, psi)
        live = np.isfinite(np.asarray(new_lw))
        assert live.any()
        np.testing.assert_allclose(got[0][..., live].numpy(), want[0][..., live].numpy(), rtol=1e-10,
                                   atol=1e-12, err_msg=f"R={R} t={t}")


def test_one_step_returns_jax_parents(jax_history):
    """_one_step(return_parents=True) returns the JAX step's parents for the
    same uniforms and leaves its other outputs as they were, bit for bit."""
    params, E_c, E_k, res = jax_history
    tp = _port_params(params)
    M, r, t = 5, 11, 12
    key = jax.random.PRNGKey(7)
    k_sys, k_mult = jax.random.split(key)
    u_sys = torch.tensor([float(jax.random.uniform(k_sys, (), dtype=jnp.float32))])
    u_mult = torch.from_numpy(np.asarray(jax.random.uniform(k_mult, (M,), dtype=jnp.float32)))[None]
    prev_lw = torch.from_numpy(np.asarray(res.log_weights[r]))[None]
    prev = torch.from_numpy(np.stack([np.asarray(f[r]) for f in res.particles]).astype(np.int32))[None]
    rows = (torch.from_numpy(np.array(E_c[t])), torch.from_numpy(np.array(E_k[t])))
    lw0, parts0 = _one_step(tp, *rows, prev_lw, prev, M, u_sys, u_mult)
    lw1, parts1, parents = _one_step(tp, *rows, prev_lw, prev, M, u_sys, u_mult, return_parents=True)
    assert torch.equal(lw0, lw1) and torch.equal(parts0, parts1)
    jprev = jm.State(*(jnp.asarray(f[r]).astype(jnp.int32) for f in res.particles))
    _, _, want = j_one_step(key, params, E_c, E_k, t, jnp.asarray(prev_lw[0].numpy()), jprev, M, True, False,
                            with_parents=True)
    np.testing.assert_array_equal(parents[0].numpy(), np.asarray(want))


def _files(path):
    out = {}
    for name in sorted(os.listdir(path)):
        if name.endswith(".npz"):
            a = np.load(os.path.join(path, name))["arr_0"]
            out[name] = (a.shape, a.dtype.str)
        else:
            out[name] = None
    return out


@pytest.mark.parametrize("robust", [False, True], ids=["betabinomial", "robust"])
def test_infer_marginal_writes_jax_names_and_shapes(tmp_path, robust):
    """``infer --marginal --device cpu`` (seeds 0 and 1, with and without
    --robust) writes the JAX runner's file names with its npz shapes and
    dtypes; split probabilities lie in [0, 1], regime rows sum to 1 per
    group; the logZ file holds a finite value; --marginal takes precedence
    over --streaming_blocks."""
    data, sg = _write_chromosome(tmp_path, "m", 50, 4)
    common = dict(data_dir=str(data), single_group_dir=str(sg), chrom="m", segment_size=40, buffer_size=5,
                  mu=MU, sigma=SIGMA, num_resampled_particles=(MM,), num_samples_backward=BB, marginal=True,
                  robust=robust)
    jax_dir = tmp_path / "jax"
    jax_infer_segment(results_dir=str(jax_dir), seed=[0, 1], marginal_window=16, **common)
    argv = ["infer", "--data_dir", str(data), "--single_group_dir", str(sg), "--results_dir", str(tmp_path / "t"),
            "--chrom", "m", "--segment_size", "40", "--buffer_size", "5", "--mu", ",".join(map(str, MU)),
            "--sigma", ",".join(map(str, SIGMA)), "--num_resampled_particles", str(MM),
            "--num_samples_backward", str(BB), "--marginal", "--marginal_window", "16", "--streaming_blocks", "8",
            "--device", "cpu"] + (["--robust"] if robust else [])
    for s in (0, 1):
        torch_cli.main(argv + ["--seed", str(s)])
    got, want = _files(tmp_path / "t" / "chrom_m_0"), _files(jax_dir / "chrom_m_0")
    assert got == want
    N = MM * (2 * 3 + 9)
    for s in (0, 1):
        path = tmp_path / "t" / "chrom_m_0"
        split = np.load(path / f"optimal_split_probs_{N}_{s}.npz")["arr_0"]
        regime = np.load(path / f"optimal_regime_probs_{N}_{s}.npz")["arr_0"]
        assert split.shape == (40,) and np.all((split >= -1e-6) & (split <= 1 + 1e-6))
        np.testing.assert_allclose(regime[:, :3].sum(1), 1.0, atol=1e-5)
        np.testing.assert_allclose(regime[:, 3:].sum(1), 1.0, atol=1e-5)
        log_z = eval((path / f"log_normalizing_constants_optimal_{s}.txt").read_text())
        assert np.isfinite(log_z[N])
        flags = (path / f"flags{s}.txt").read_text()
        assert "--marginal=True" in flags and "--streaming_blocks=8" in flags
    assert gzip.decompress((tmp_path / "t" / "chrom_m_0" / "positions.csv.gz").read_bytes()) == gzip.decompress(
        (jax_dir / "chrom_m_0" / "positions.csv.gz").read_bytes())
