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
    assert cuda_resampling.supports(26000, 50) is None  # 8 bytes a weight: to ~28,800 weights
    assert "shared memory" in cuda_resampling.supports(29000, 50)
    assert "shared memory" in cuda_resampling.supports(48 * 600, 600)  # two-group M=600
    # The layout: a scratch region (6 histograms of 256 bins and two exchange
    # buffers of one 8-byte key a thread, or the N prefix sums when those are
    # larger), N weights, three (M+1)-slot arrays.
    assert cuda_resampling.smem_bytes(250, 244) == (6 * 1024 + 16 * 256) + 4 * 250 + 12 * 245
    assert cuda_resampling.smem_bytes(2400, 50) == (6 * 1024 + 16 * 512) + 4 * 2400 + 12 * 51
    assert cuda_resampling.smem_bytes(24000, 500) == 4 * 24000 + 4 * 24000 + 12 * 501
    assert cuda_resampling.smem_bytes(2049, 1000) == (6 * 1024 + 16 * 1024) + 4 * 2049 + 12 * 1001
    # The block size switches at N = 256 / 257 and where M + 1 passes a power
    # of two above that.
    assert [cuda_resampling.threads(n, 50) for n in (1, 250, 256, 257, 2400, 24000)] == [
        256, 256, 256, 512, 512, 512]
    assert [cuda_resampling.threads(2400, m) for m in (1, 255, 511, 512, 1023)] == [512, 512, 512, 1024, 1024]
    assert [cuda_resampling.threads(250, m) for m in (244, 255, 256)] == [256, 256, 512]


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


# ---- the arithmetic the CUDA kernel relies on, restated in numpy and torch ----
# Nothing on a run's path calls these: they state what csrc/optimal_resampling.cu
# does where it departs from a sort and a count per offspring (the same 64-bit
# key, digit plan and stopping rule), and the tests hold each against the plain
# version's ``_top_k`` or ``_count_below``.

def _order_key(x):
    """f32 -> uint64 below 2**32 whose order is the floats' order (the
    kernel's order_key): the sign bit flipped for non-negative values, every
    bit for negative ones. -0.0 and +0.0 get one key; -inf gets the lowest
    key of the non-NaN."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = np.where(b == 0x80000000, np.uint64(0), b)
    return np.where(b >= 0x80000000, np.uint64(0xFFFFFFFF) - b, b | np.uint64(0x80000000))


def _sort_key(x):
    """The kernel's sort_key: (order key << 32) | ~index as a 32-bit word.
    Larger = better: value descending, then index ascending; all distinct."""
    i = np.arange(x.shape[-1], dtype=np.uint64)
    return (_order_key(x) << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - i)


def _top_k_by_select(x, m):
    """The top min(m + 1, N) of each row as the kernel takes them. A block
    of T = threads(N, m) threads sorts up to T keys directly; a longer row
    first goes through the radix select: 8-bit digits of the 64-bit key at
    bits 56, 48, 40, 32 (the value), then 8 and 0 (the index, whose bits
    16..31 are ones for every i < 65536), until the keys at or above the
    pivot's prefix number at most ``cap`` (256, or the power of two that
    holds m + 1). Those are sorted and the first taken. x (U, N) f32."""
    n = x.shape[-1]
    kk = min(m + 1, n)
    t = cuda_resampling.threads(n, m)
    cap = cuda_resampling.MIN_THREADS
    while cap < kk:
        cap *= 2
    picked, passes = [], []
    for row in _sort_key(x):
        prefix, need, cand, p = 0, kk, n, 0
        if n > t:
            while p < cuda_resampling.RADIX_PASSES and cand > cap:
                shift = 56 - 8 * p if p < 4 else 8 * (5 - p)
                if p == 4:
                    prefix |= 0xFFFF0000
                above = np.uint64(shift + 8)
                in_bin = (row >> above) == (np.uint64(prefix) >> above) if p else np.ones(n, bool)
                hist = np.bincount(((row[in_bin] >> np.uint64(shift)) & np.uint64(255)).astype(np.int64),
                                   minlength=256)
                at_or_above = np.cumsum(hist[::-1])[::-1]
                digit = int(np.nonzero(at_or_above >= need)[0].max())
                need -= int(at_or_above[digit] - hist[digit])
                prefix |= digit << shift
                cand = (kk - need) + int(hist[digit])
                p += 1
        candidates = row[row >= np.uint64(prefix)]
        assert candidates.size == cand and kk <= cand <= max(cap, t if n <= t else 0), (cand, cap)
        top = np.sort(candidates)[::-1][:kk]
        picked.append((np.uint64(0xFFFFFFFF) - (top & np.uint64(0xFFFFFFFF))).astype(np.int64))
        passes.append(p)
    idx = np.stack(picked)
    return np.take_along_axis(x, idx, -1), idx, passes


def _systematic_counts_by_histogram(q, u, l, n_res):
    """#{i: q_i < t_g} for the systematic thresholds t_g = (g + u) / l *
    q[-1], g = 0..n_res-1, in O(N + n_res) as the kernel takes them: t_g
    does not decrease in g, so each q_i finds the first g with q_i < t_g (a
    guess, then steps against the same f32 thresholds) and adds one to that
    bin; the inclusive scan of the bins is the count. q (N,) f32, need not
    be sorted; u and l f32 scalars (tensors)."""
    total = q[-1]

    def threshold(g):
        return (g.to(torch.float32) + u) / l * total

    if float(total) > 0:
        g = torch.clamp(torch.ceil(q * (l / total) - u), 0, n_res).to(torch.int64)
    else:
        g = torch.full(q.shape, n_res, dtype=torch.int64, device=q.device)
    while True:
        down = (g > 0) & (q < threshold(g - 1))
        if not bool(down.any()):
            break
        g = g - down.to(torch.int64)
    while True:
        up = (g < n_res) & ~(q < threshold(g))
        if not bool(up.any()):
            break
        g = g + up.to(torch.int64)
    return torch.cumsum(torch.bincount(g[g < n_res], minlength=n_res)[:n_res], 0)


def _better(v, i, v2, i2):
    """The kernel's strict order: value descending, then index ascending."""
    return (v > v2) or (v == v2 and i < i2)


def _key_samples():
    rng = np.random.default_rng(11)
    tiny = np.float32(1e-45)  # the smallest subnormal
    special = np.array(
        [-np.inf, np.inf, 0.0, -0.0, tiny, -tiny, 1e-39, -1e-39, 1.0, -1.0, 1.0, -1.0,
         np.finfo(np.float32).max, np.finfo(np.float32).min, np.finfo(np.float32).tiny,
         -np.finfo(np.float32).tiny, -87.3, -87.3, -103.9], np.float32)
    return np.concatenate([special, -np.abs(rng.gumbel(size=40)).astype(np.float32) * 10,
                           rng.normal(size=40).astype(np.float32)])


def test_order_key_is_the_float_order():
    """key(a) > key(b) iff a > b and key(a) == key(b) iff a == b, on f32
    samples with -inf, +-0.0 (one key), subnormals and equal values; the
    key with the index appended orders as the kernel's better()."""
    x = _key_samples()
    key = _order_key(x)
    assert key.dtype == np.uint64 and key.max() < 2**32
    gt = x[:, None] > x[None, :]
    eq = x[:, None] == x[None, :]
    np.testing.assert_array_equal(key[:, None] > key[None, :], gt)
    np.testing.assert_array_equal(key[:, None] == key[None, :], eq)
    assert key[np.isneginf(x)].max() == key.min()
    full = _sort_key(x)
    assert full.min() > 0  # 0 is the sort's padding and ranks below every key
    for i in range(x.size):
        for j in range(x.size):
            if i != j:
                assert (full[i] > full[j]) == _better(x[i], i, x[j], j), (x[i], i, x[j], j)


def _select_case(name):
    rng = np.random.default_rng(12)
    if name == "continuous":
        return _gumbel_weights(3, 3), 51
    if name == "many_ties":  # four distinct values and dead slots
        x = rng.integers(0, 4, size=(3, 3000)).astype(np.float32)
        x[:, ::7] = -np.inf
        return x, 51
    if name == "all_equal":
        return np.full((2, N), -np.log(N), np.float32), 51
    if name == "few_finite":  # fewer than k finite weights: -inf ties by index
        x = np.full((3, N), -np.inf, np.float32)
        x[:, rng.choice(N, 10, replace=False)] = rng.gumbel(size=10)
        return x, 51
    if name == "all_but_3_dead":
        x = np.full((2, 700), -np.inf, np.float32)
        x[:, [5, 699, 300]] = np.array([0.0, -0.0, -1.5], np.float32)  # +-0.0: one key, by index
        return x, 245
    if name == "m150":
        x = rng.gumbel(size=(2, 7200)).astype(np.float32) * 3
        x[rng.uniform(size=x.shape) < 0.2] = -np.inf
        return x, 151
    if name == "engine":  # N <= capacity: sorted directly
        x = rng.gumbel(size=(4, 250)).astype(np.float32)
        x[1, 12:] = -np.inf
        x[2] = np.round(x[2])
        return x, 245
    raise ValueError(name)


@pytest.mark.parametrize(
    "case", ["continuous", "many_ties", "all_equal", "few_finite", "all_but_3_dead", "m150", "engine"])
def test_select_then_sort_top_set_equals_top_k(case):
    """The radix select over (order key, ~index), then a sort of what is
    left, gives _top_k's values and indices: ties lowest index first, -inf
    weights ranked by index when fewer than k are finite."""
    x, k = _select_case(case)
    want_v, want_i = tres._top_k(torch.from_numpy(x), k)
    got_v, got_i, passes = _top_k_by_select(x, k - 1)
    np.testing.assert_array_equal(got_i, want_i.numpy())
    np.testing.assert_array_equal(got_v, want_v.numpy())
    for u in range(min(2, x.shape[0])):
        _, ji = jax.lax.top_k(jnp.asarray(x[u]), k)
        np.testing.assert_array_equal(got_i[u], np.asarray(ji))
    # At most two passes on continuous weights; exact ties go on through the
    # index digits; a row that fits a block is sorted without a select.
    most = {"continuous": 2, "m150": 2, "engine": 0}
    if case in most:
        assert max(passes) <= most[case], passes
    if case == "all_equal":  # four value digits, then the index's upper digit leaves 256
        assert passes == [5, 5]


def _histogram_case(name):
    """(q, u, l, n_res): prefix sums, the systematic uniform, the divisor
    and the number of resampled offspring."""
    rng = np.random.default_rng(13)
    f32 = np.float32
    if name in ("gumbel", "u_zero", "u_just_under_one"):
        w = np.exp(_gumbel_weights(4, 1)[0]).astype(f32)
        w[np.argsort(w)[-7:]] = 0.0  # the kept ones are masked out
        u = {"gumbel": f32(rng.uniform()), "u_zero": f32(0.0),
             "u_just_under_one": np.nextafter(f32(1.0), f32(0.0))}[name]
        return np.cumsum(w, dtype=f32), u, f32(43.0), 43
    if name == "exact_hits":  # dyadic masses: thresholds equal prefix sums exactly
        w = np.full(64, 1.0 / 64, f32)
        return np.cumsum(w, dtype=f32), f32(0.0), f32(8.0), 8
    if name == "exact_hits_half":
        w = np.full(128, 1.0 / 128, f32)
        return np.cumsum(w, dtype=f32), f32(0.5), f32(16.0), 16
    if name == "zero_mass_runs":
        w = np.zeros(500, f32)
        w[[3, 4, 250, 499]] = [0.25, 0.125, 0.5, 0.125]
        return np.cumsum(w, dtype=f32), f32(0.3), f32(50.0), 50
    if name == "zero_total":
        return np.zeros(300, f32), f32(0.7), f32(12.0), 12
    if name == "not_monotone":  # a blocked scan may round a prefix down
        w = rng.uniform(size=1000).astype(f32)
        q = np.cumsum(w / w.sum(), dtype=f32)
        q[100:900:37] = np.nextafter(q[99:899:37], f32(0.0))
        return q, f32(rng.uniform()), f32(244.0), 244
    if name == "engine_shape":
        w = np.exp(_norm(rng.gumbel(size=250).astype(f32))).astype(f32)
        return np.cumsum(w, dtype=f32), f32(rng.uniform()), f32(240.0), 240
    if name == "none_resampled":
        w = rng.uniform(size=100).astype(f32)
        return np.cumsum(w, dtype=f32), f32(0.4), f32(1.0), 0
    raise ValueError(name)


@pytest.mark.parametrize("case", [
    "gumbel", "u_zero", "u_just_under_one", "exact_hits", "exact_hits_half", "zero_mass_runs",
    "zero_total", "not_monotone", "engine_shape", "none_resampled"])
def test_offspring_histogram_equals_comparison_counts(case):
    """One bin per offspring, filled by each prefix sum's first threshold
    above it and scanned, equals _count_below exactly: thresholds that hit
    a prefix sum, zero-mass runs, u at 0 and just under 1, a prefix that is
    not monotone."""
    q, u, l, n_res = _histogram_case(case)
    qt, ut, lt = torch.from_numpy(q), torch.tensor(u), torch.tensor(l)
    t = (torch.arange(n_res, dtype=torch.float32) + ut) / lt * qt[-1]
    assert t.dtype == torch.float32 and bool((t[1:] >= t[:-1]).all())
    want = tres._count_below(qt[None], t[None])[0]
    got = _systematic_counts_by_histogram(qt, ut, lt, n_res)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(want.numpy(), (q[None, :] < t.numpy()[:, None]).sum(1))
    if case.startswith("exact_hits"):
        assert np.isin(t.numpy(), q).sum() >= n_res - 1
