"""The port's plain resamplers against the JAX package's, on shared uniforms.

The uniforms are derived here exactly as the JAX functions derive them from
their key (hygeia_tpu/ops/resampling.py:260-263 and :139), so on continuous
random weights the selections must agree exactly. log_c and the new weights
are f32 values computed with other summation orders: rtol 1e-5.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hygeia_tpu.ops.pallas_resampling import _SLOTS as PALLAS_SLOTS, optimal_finite_state_resampling_pallas
from hygeia_tpu.ops import resampling as jres
from hygeia_tpu_torch.ops import resampling as tres
from hygeia_tpu_torch.ops import cuda_resampling

# The tensors here are small: one intra-op thread per test worker keeps the
# parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

N, M = 2400, 50


def _norm(lw):
    return np.asarray(lw - jax.scipy.special.logsumexp(jnp.asarray(lw)), np.float32)


def _uniforms(key, m, n_mult=None):
    """(u_sys, u_mult) as optimal_finite_state_resampling draws them."""
    key_sys, key_mult = jax.random.split(key)
    u = jax.random.uniform(key_sys, (), dtype=jnp.float32)
    if n_mult is None:
        um = jax.random.uniform(key_mult, (m,), dtype=jnp.float32)
    else:  # the Pallas wrapper draws a (SLOTS, 1) column
        um = jax.random.uniform(key_mult, (n_mult, 1), dtype=jnp.float32)[:m, 0]
    return float(u), np.asarray(um)


def _gumbel_weights(seed, trials):
    rng = np.random.default_rng(seed)
    out = []
    for trial in range(trials):
        lw = rng.gumbel(size=N).astype(np.float32) * (1.0 + trial)
        lw = np.where(rng.uniform(size=N) < 0.2, -np.inf, lw)
        out.append(_norm(lw))
    return np.stack(out)


def _port(lwn, us, um):
    return tres.optimal_finite_state_resampling(
        torch.from_numpy(np.array(lwn, np.float32)), M,
        torch.tensor(us, dtype=torch.float32), torch.from_numpy(np.asarray(um, np.float32)),
    )


def _assert_matches(got, ref, u, label):
    assert bool(got.use_unbiased[u]) == bool(ref.use_unbiased), label
    np.testing.assert_allclose(float(got.log_c[u]), float(ref.log_c), rtol=1e-5, atol=1e-6, err_msg=label)
    np.testing.assert_array_equal(got.top_m_indices[u].numpy(), np.asarray(ref.top_m_indices), err_msg=label)
    np.testing.assert_array_equal(got.parent_indices[u].numpy(), np.asarray(ref.parent_indices), err_msg=label)
    np.testing.assert_allclose(
        got.new_log_weights[u].numpy(), np.asarray(ref.new_log_weights), rtol=1e-5, atol=1e-6, err_msg=label
    )


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
def test_optimal_resampler_matches_jax(reference):
    """8 units of Gumbel weights at rising temperature, 20% dead slots,
    resampled in ONE batched port call; each unit against the JAX function
    (the XLA composition, or the Pallas kernel in interpret mode)."""
    trials = 8
    lwn = _gumbel_weights(0, trials)
    keys = [jax.random.PRNGKey(t) for t in range(trials)]
    n_mult = None if reference == "xla" else PALLAS_SLOTS
    draws = [_uniforms(k, M, n_mult) for k in keys]
    got = _port(lwn, [d[0] for d in draws], np.stack([d[1] for d in draws]))
    for t in range(trials):
        if reference == "xla":
            ref = jres.optimal_finite_state_resampling(keys[t], jnp.asarray(lwn[t]), M, normalized=True)
        else:
            ref = optimal_finite_state_resampling_pallas(keys[t], jnp.asarray(lwn[t]), M, interpret=True)
        _assert_matches(got, ref, t, f"{reference} trial {t}")


def test_optimal_resampler_fallback_matches_jax():
    """Fewer than M live weights: no consistent threshold, multinomial
    fallback with log_c = 0, parents only among the live slots."""
    key = jax.random.PRNGKey(3)
    lw = np.full(N, -np.inf, np.float32)
    lw[:10] = 0.0
    lwn = _norm(lw)[None]
    us, um = _uniforms(key, M)
    got = _port(lwn, [us], um[None])
    ref = jres.optimal_finite_state_resampling(key, jnp.asarray(lwn[0]), M, normalized=True)
    assert bool(got.use_unbiased[0]) and bool(ref.use_unbiased)
    assert float(got.log_c[0]) == 0.0
    assert np.all(got.parent_indices.numpy() < 10)
    _assert_matches(got, ref, 0, "fallback")


def test_optimal_resampler_ties_invariant():
    """All-equal weights (exact ties): the Fearnhead invariant
    sum_i min(1, c W_i) = M holds, and every parent is in range."""
    key = jax.random.PRNGKey(3)
    lwn = _norm(np.zeros(N, np.float32))[None]
    us, um = _uniforms(key, M)
    got = _port(lwn, [us], um[None])
    assert not bool(got.use_unbiased[0])
    c = np.exp(float(got.log_c[0]))
    np.testing.assert_allclose(np.minimum(1.0, c * np.exp(lwn[0].astype(np.float64))).sum(), M, rtol=1e-3)
    p = got.parent_indices.numpy()
    assert p.min() >= 0 and p.max() < N


def test_top_k_tie_order_is_lowest_index_first():
    """Equal values come out lowest index first, as lax.top_k orders them;
    -inf ties too."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 4, size=(3, 300)).astype(np.float32)
    x[:, ::7] = -np.inf
    vals, idx = tres._top_k(torch.from_numpy(x), 120)
    for u in range(3):
        jv, ji = jax.lax.top_k(jnp.asarray(x[u]), 120)
        np.testing.assert_array_equal(idx[u].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals[u].numpy(), np.asarray(jv))
    km = tres.keep_top_m(torch.from_numpy(x), 40)
    ref = jres.keep_top_m(jnp.asarray(x[0]), 40)
    np.testing.assert_array_equal(km.parent_indices[0].numpy(), np.asarray(ref.parent_indices))


@pytest.mark.parametrize("multinomial", [False, True])
def test_unbiased_resampling_matches_jax(multinomial):
    """Systematic and multinomial selection with the same uniform(s)."""
    lwn = _gumbel_weights(5, 3)
    keys = [jax.random.PRNGKey(10 + t) for t in range(3)]
    us = [float(jax.random.uniform(k, (), dtype=jnp.float32)) for k in keys]
    um = np.stack([np.asarray(jax.random.uniform(k, (M,), dtype=jnp.float32)) for k in keys])
    got = tres.unbiased_resampling(
        torch.from_numpy(lwn), M, torch.tensor(us), torch.from_numpy(um),
        multinomial=multinomial, normalized=True,
    )
    for t in range(3):
        ref = jres.unbiased_resampling(keys[t], jnp.asarray(lwn[t]), M, multinomial=multinomial, normalized=True)
        np.testing.assert_array_equal(got.parent_indices[t].numpy(), np.asarray(ref.parent_indices))
        np.testing.assert_array_equal(got.top_m_indices[t].numpy(), np.asarray(ref.top_m_indices))
        np.testing.assert_allclose(got.new_log_weights[t].numpy(), np.asarray(ref.new_log_weights), rtol=1e-6)


def test_wrapper_takes_plain_version_only_for_cpu_tensors():
    """A CPU tensor goes to the plain version (no launch counted); any other
    device goes to the kernel path, which raises here instead of falling
    back."""
    lwn = torch.from_numpy(_gumbel_weights(2, 2))
    us, um = torch.rand(2), torch.rand(2, M)
    before = cuda_resampling.KERNEL.launches
    got = cuda_resampling.optimal_resampling(lwn, M, us, um)
    want = tres.optimal_finite_state_resampling(lwn, M, us, um)
    assert torch.equal(got.parent_indices, want.parent_indices)
    assert cuda_resampling.KERNEL.launches == before
    meta = lwn.to("meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_resampling.optimal_resampling(meta, M, us.to("meta"), um.to("meta"))
    assert cuda_resampling.KERNEL.launches == before


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """On a host without nvcc the build raises; nothing is built."""
    from hygeia_tpu_torch.ops import build

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU toolchain; the build is tested on the card")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_library()
    assert not (tmp_path / "_build").exists()


def test_supports_names_the_bound_without_a_card():
    """The kernel's shape bound, checked in Python: M + 1 <= 1024 and one
    unit within an H100 block's opt-in shared memory."""
    for n, m in ((250, 244), (7200, 150), (2400, 50), (24000, 500), (100, 127)):
        assert cuda_resampling.supports(n, m) is None, (n, m)
    assert "M + 1 <= 1024" in cuda_resampling.supports(2400, 1024)
    assert "M + 1 <= 1024" in cuda_resampling.supports(2400, 0)
    assert "shared memory" in cuda_resampling.supports(26000, 50)
    assert "shared memory" in cuda_resampling.supports(48 * 600, 600)  # two-group M=600
    assert cuda_resampling.smem_bytes(250, 244) == 9 * 250 + 12 * 245 + 8 * 256


def test_optimal_resampler_matches_jax_at_the_engine_shape():
    """N = 250 weights, M_cap = 244 offspring (the single-group engine at
    the CLI default): growth-phase weights (the first 6(t+1) slots live)
    and at-capacity Gumbel weights, each unit against the JAX function."""
    n, m = 250, 244
    rng = np.random.default_rng(8)
    rows = []
    for t in (1, 20, 40):
        lw = np.full(n, -np.inf, np.float32)
        lw[: 6 * (t + 1)] = rng.gumbel(size=6 * (t + 1))
        rows.append(_norm(lw))
    for trial in range(5):
        rows.append(_norm(rng.gumbel(size=n).astype(np.float32) * (1.0 + trial)))
    lwn = np.stack(rows)
    keys = [jax.random.PRNGKey(40 + i) for i in range(len(rows))]
    draws = [_uniforms(k, m) for k in keys]
    got = tres.optimal_finite_state_resampling(
        torch.from_numpy(lwn), m, torch.tensor([d[0] for d in draws], dtype=torch.float32),
        torch.from_numpy(np.stack([d[1] for d in draws])),
    )
    for i, key in enumerate(keys):
        ref = jres.optimal_finite_state_resampling(key, jnp.asarray(lwn[i]), m, normalized=True)
        _assert_matches(got, ref, i, f"row {i}")
    assert bool(got.use_unbiased[0]) and not bool(got.use_unbiased[-1])
