"""The port on the card: the optimal-resampler kernel K1, the filter-step
kernel K2 and the backward-step kernel K3 against their plain PyTorch
versions on the same tensors and uniforms, the single-group hazard tables
against the CPU's, and the paths that go through the kernels.

Marked ``cuda``; skipped where there is no CUDA device. On the machine with
the GPU (no JAX there, so without the repo's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: parents, top-M indices and fallback flags equal; log_c and the
new weights rtol 1e-5 (f32 sums taken in another order); the hazard,
emission and robust tables bit-identical (they are built from exactly
rounded operations only). The single-group pipeline on the card against
its CPU run (other generator streams): regime probabilities within 0.05
mean absolute, modes equal on 90% of the sites both call confident. The
marginal filter on the card against the CPU with the same uniforms: the
functionals within 0.02, logZ within rtol 1e-4 (the kernel's log_c is
rtol 1e-5 of the plain version's, and the psi product sums in another
order). The filter-step kernel K2 against its plain version from the
same K1 outputs: children, parents, the -inf pattern and the degenerate
flags equal; finite weights and shifts within atol 2e-5, rtol 1e-6 (its
terms are the plain version's bit for bit; the shift's sum of
exponentials is taken in another order). K3 against its plain version
from the same carry and uniforms: the draws equal; a row that differed
would have to be a tie within float32 rounding of the plain version's
largest noisy logits (its terms are the plain version's bit for bit).
The engine-step kernel K4 against the plain composition from the same
state: particles, insertion slots, finalisations and counts equal; every
value within 2e-6 + 2e-5 s, s the size of what it is summed from: its own
|value|, or a row of psi's or a column of phi's largest over the
particles (f32 sums taken in another order).
"""

import numpy as np
import pytest
import torch

from hygeia_tpu_torch.ops import resampling as plain
from hygeia_tpu_torch.ops import cuda_backward_step as k3
from hygeia_tpu_torch.ops import cuda_filter_step as k2
from hygeia_tpu_torch.ops import cuda_resampling as cr

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def _weights(rng, U, N, scale, device, dead=0.2):
    lw = rng.gumbel(size=(U, N)).astype(np.float32) * scale
    lw = np.where(rng.uniform(size=(U, N)) < dead, -np.inf, lw).astype(np.float32)
    t = torch.from_numpy(lw).to(device)
    return (t - torch.logsumexp(t, dim=-1, keepdim=True)).contiguous()


@pytest.mark.parametrize("U,N,M", [
    (32, 2400, 50), (1, 2400, 50), (3, 240, 5), (5, 1000, 127), (2, 100, 127), (1, 2400, 1),
    (1, 250, 244), (8, 250, 244), (2, 7200, 150), (1, 2049, 1000),
])
def test_kernel_matches_plain(device, U, N, M):
    rng = np.random.default_rng(N + M)
    g = torch.Generator(device=device).manual_seed(0)
    for trial in range(4):
        lw = _weights(rng, U, N, 1.0 + 2 * trial, device)
        us = torch.rand((U,), generator=g, device=device)
        um = torch.rand((U, M), generator=g, device=device)
        got = cr.optimal_resampling(lw, M, us, um)
        want = plain.optimal_finite_state_resampling(lw, M, us, um)
        assert torch.equal(got.use_unbiased, want.use_unbiased)
        assert torch.equal(got.top_m_indices, want.top_m_indices)
        assert torch.equal(got.parent_indices, want.parent_indices)
        torch.testing.assert_close(got.log_c, want.log_c, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got.new_log_weights, want.new_log_weights, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("N,M", [(24000, 500), (28500, 50)])
def test_kernel_at_the_shared_memory_bound(device, N, M):
    """N = 24,000 weights, M = 500 (~200 KB of shared memory) and N = 28,500,
    M = 50 (~225 KB, the most a block may have). Selection of
    the resampled offspring compares grid points against f32 prefix sums
    over that many weights, which the kernel (one order over 256 lanes,
    unchanged by the redesign) and torch.cumsum round in other
    orders: a grid point within that rounding of a boundary may pick the
    neighbour, so parents must agree on 99% of the slots, the rest exactly."""
    rng = np.random.default_rng(7)
    g = torch.Generator(device=device).manual_seed(0)
    U = 2
    assert cr.supports(N, M) is None
    for trial in range(2):
        lw = _weights(rng, U, N, 1.0 + 2 * trial, device)
        us = torch.rand((U,), generator=g, device=device)
        um = torch.rand((U, M), generator=g, device=device)
        got = cr.optimal_resampling(lw, M, us, um)
        want = plain.optimal_finite_state_resampling(lw, M, us, um)
        assert torch.equal(got.use_unbiased, want.use_unbiased)
        assert torch.equal(got.top_m_indices, want.top_m_indices)
        torch.testing.assert_close(got.log_c, want.log_c, rtol=1e-5, atol=1e-6)
        same = (got.parent_indices == want.parent_indices).double().mean().item()
        assert same >= 0.99, same


def _compare(device, lw, M, exact_parents=True):
    U = lw.shape[0]
    g = torch.Generator(device=device).manual_seed(1)
    us = torch.rand((U,), generator=g, device=device)
    um = torch.rand((U, M), generator=g, device=device)
    got = cr.optimal_resampling(lw, M, us, um)
    want = plain.optimal_finite_state_resampling(lw, M, us, um)
    torch.cuda.synchronize(device)
    assert torch.equal(got.use_unbiased, want.use_unbiased)
    assert torch.equal(got.top_m_indices, want.top_m_indices)
    torch.testing.assert_close(got.log_c, want.log_c, rtol=1e-5, atol=1e-6)
    if exact_parents:
        assert torch.equal(got.parent_indices, want.parent_indices)
        torch.testing.assert_close(got.new_log_weights, want.new_log_weights, rtol=1e-5, atol=1e-6)
    assert int(got.parent_indices.min()) >= 0 and int(got.parent_indices.max()) < lw.shape[1]
    return got


def _normalise(t):
    return (t - torch.logsumexp(t, dim=-1, keepdim=True)).contiguous()


@pytest.mark.parametrize("U", [1, 132])
@pytest.mark.parametrize("N,M", [(250, 244), (2400, 50)])
@pytest.mark.parametrize("case", ["all_equal", "ties_fill_the_top_set", "all_but_3_dead"])
def test_kernel_corner_cases_at_the_main_shapes(device, U, N, M, case):
    """Exact ties and -inf runs at both main paths' shapes, one unit and one
    per SM: the radix select has to go on into the index bits, and the
    top set has to come out lowest index first. With exact ties the prefix
    sums of kernel and torch.cumsum may round a grid point to either
    neighbour, so the resampled parents are held to the range only."""
    rng = np.random.default_rng(N + U)
    if case == "all_equal":
        lw = torch.zeros((U, N), device=device)
    elif case == "ties_fill_the_top_set":
        x = rng.gumbel(size=(U, N)).astype(np.float32) - 30.0
        for u in range(U):
            x[u, rng.choice(N, min(M + 6, N), replace=False)] = 0.0
        lw = torch.from_numpy(x).to(device)
    else:
        x = np.full((U, N), -np.inf, np.float32)
        for u in range(U):
            x[u, rng.choice(N, 3, replace=False)] = rng.gumbel(size=3)
        lw = torch.from_numpy(x).to(device)
    got = _compare(device, _normalise(lw), M, exact_parents=(case == "all_but_3_dead"))
    if case == "all_but_3_dead":
        assert bool(got.use_unbiased.all())  # 3 live < M: the multinomial fallback
        live = torch.isfinite(lw).gather(1, got.parent_indices.long())
        assert bool(live.all())
    else:
        assert not bool(got.use_unbiased.any())
        c = torch.exp(got.log_c.double())[:, None]
        mass = torch.clamp(c * torch.exp(_normalise(lw).double()), max=1.0).sum(dim=-1)
        torch.testing.assert_close(mass, torch.full_like(mass, M), rtol=1e-3, atol=0)


@pytest.mark.parametrize("N,M,threads", [
    (256, 100, 256), (257, 100, 512), (600, 254, 512), (600, 255, 512), (600, 256, 512),
    (1500, 511, 512), (1500, 512, 1024), (250, 255, 256), (250, 256, 512),
])
def test_kernel_on_both_sides_of_the_block_size_switch(device, N, M, threads):
    """The block has 256 threads up to N = 256 and 512 above, and the next
    power of two >= M + 1 when that is more; the outputs do not depend on
    it (the sums that reach an output keep one order over 256 lanes)."""
    assert cr.threads(N, M) == threads
    rng = np.random.default_rng(N * M)
    for trial in range(3):
        _compare(device, _weights(rng, 3, N, 1.0 + 3 * trial, device, dead=0.1 * trial), M)


def test_kernel_counts_launches_and_rejects_what_it_cannot_take(device):
    lw = _weights(np.random.default_rng(0), 2, 240, 1.0, device)
    us, um = torch.rand(2, device=device), torch.rand(2, 5, device=device)
    before = cr.KERNEL.launches
    cr.optimal_resampling(lw, 5, us, um)
    assert cr.KERNEL.launches == before + 1
    with pytest.raises(ValueError, match="M \\+ 1"):
        cr.optimal_resampling(lw, 1024, us, torch.rand(2, 1024, device=device))
    with pytest.raises(TypeError):
        cr.optimal_resampling(lw.double(), 5, us, um)
    big = torch.zeros((1, 30000), device=device)
    with pytest.raises(ValueError, match="shared memory"):
        cr.optimal_resampling(big, 5, us[:1], um[:1])
    with pytest.raises(ValueError, match="contiguous"):
        cr.optimal_resampling(lw.t().contiguous().t(), 5, us, um)
    assert cr.KERNEL.launches == before + 1


def test_filter_on_the_card_goes_through_the_kernel(device):
    from hygeia_tpu_torch.two_group.filter import run_filter
    from hygeia_tpu_torch.two_group.model import make_params
    from hygeia_tpu_torch.ops.emissions import emission_log_prob_table

    R, T, M = 6, 50, 10
    rng = np.random.default_rng(1)
    params = make_params(
        mu=[0.95, 0.05, 0.80, 0.20, 0.50, 0.50], sigma=[0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751],
        p_softmax_control=np.zeros((R, R)), omega_logit_control=np.full(R, 4.0), omega_case=0.8,
        kappa_control=np.full(R, 2.0), kappa_case=np.full(R, 2.0), merge_log_prob=np.log(0.1),
        split_prob=0.01, minimum_duration=3, d_max=64, device=device,
    )
    n = rng.poisson(20, size=(T, 2))
    y = rng.binomial(n, 0.7)
    E = emission_log_prob_table(y, n, params.alpha, params.beta)
    before, before_k2 = cr.KERNEL.launches, k2.KERNEL.launches
    res = run_filter(params, E, E, M, n_units=3, generator=torch.Generator(device=device).manual_seed(0))
    assert cr.KERNEL.launches - before == T - 1
    assert k2.KERNEL.launches - before_k2 == T - 1
    assert bool(torch.isfinite(res.log_normalizing_constant).all())
    assert int(res.degenerate_steps.sum()) == 0


# ---- K2, the filter step after the resampler (ops/cuda_filter_step.py) ------

def _k2_params(device, R, T):
    from hygeia_tpu_torch.two_group.model import make_params

    return make_params(
        mu=[0.95, 0.05, 0.80, 0.20, 0.50, 0.50][:R], sigma=[0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751][:R],
        p_softmax_control=np.zeros((R, R)), omega_logit_control=np.full(R, 4.0), omega_case=0.8,
        kappa_control=np.full(R, 2.0), kappa_case=np.full(R, 2.0), merge_log_prob=np.log(0.1),
        split_prob=0.01, minimum_duration=3, d_max=T + 1, device=device,
    )


def _k2_inputs(device, case):
    """(params, E_c, E_k, t, lw, parts, K1's result) of one filter site at
    M = 50: the carry after ``t`` sites of run_filter on the card, altered
    as ``case`` asks."""
    from hygeia_tpu_torch.two_group.filter import run_filter

    R = 5 if case == "r5" else 6
    U = 32 if case == "u32" else 2
    M, T = 50, 40
    t = 1 if case == "no_resample" else 12  # 1: the site after a cold start (R^2 = 36 live)
    params = _k2_params(device, R, T)
    E_c, E_k = _graph_tables(params, T, U, seed=3)
    if case != "per_unit_rows":
        E_c, E_k = E_c[0], E_k[0]
    prev = run_filter(params, E_c[..., :t, :], E_k[..., :t, :], M, n_units=U,
                      generator=torch.Generator(device=device).manual_seed(21), return_history=False)
    lw, parts = prev.log_weights.contiguous(), torch.stack(prev.particles, 1).contiguous()
    rng = np.random.default_rng(4)
    if case == "dead_ancestors":  # a third of the live particles dead, their weights finite
        parts[:, 2][torch.from_numpy(rng.uniform(size=tuple(lw.shape)) < 0.33).to(device)] = -1
    if case == "all_dead":  # unit 0: every ancestor dead, so every child
        parts[0, 2] = -1
    g = torch.Generator(device=device).manual_seed(9)
    u_sys, u_mult = torch.rand((U,), generator=g, device=device), torch.rand((U, M), generator=g, device=device)
    res = cr.optimal_resampling(lw, M, u_sys, u_mult)
    if case == "unbiased":  # K1's fallback flag on unit 1
        res = res._replace(use_unbiased=torch.tensor([False, True], device=device))
    return params, E_c, E_k, t, lw, parts, M, res


def _k2_launch(params, E_c, E_k, t, lw, parts, M, res, out=None):
    """K2 at site t into ``out`` (default: new tensors), with a fresh
    history, shifts, flags and parents: (out_lw, out_parts, shifts, degen,
    hist, parents)."""
    U, N = lw.shape
    T, dev = E_c.shape[-2], lw.device
    out_lw, out_parts = out if out is not None else (torch.empty_like(lw), torch.empty_like(parts))
    shifts = torch.zeros((U, T - 1), device=dev)
    degen = torch.zeros((U, T - 1), dtype=torch.bool, device=dev)
    hist = tuple(torch.zeros((U, T, N), dtype=dt, device=dev) for dt in k2.HISTORY_DTYPES)
    parents = torch.empty((U, M), dtype=torch.int64, device=dev)
    st = params.step_tables()
    k2.filter_step_cuda(E_c, E_k, torch.tensor([t - 1, t], device=dev), lw, parts, res, M, st.rho_both,
                        params.log_p_control, params.log_p_merged, params.min_duration, out_lw, out_parts,
                        shifts, degen, hist, parents)
    return out_lw, out_parts, shifts, degen, hist, parents


@pytest.mark.parametrize("case", ["cell", "r5", "u32", "per_unit_rows", "dead_ancestors", "no_resample",
                                  "unbiased", "all_dead"])
def test_k2_matches_the_plain_composition(device, case):
    """K2 against _expand_and_weigh + _renormalise on the card, from the
    same weights, particles, K1 outputs and emission rows. Children,
    parents, the -inf pattern and the degenerate flags are equal; the
    finite weights and the shifts agree within atol 2e-5, rtol 1e-6: every
    term before the renormalisation is the plain version's bit for bit,
    and the shift is a sum of f32 exponentials taken in another order
    (~1e-6), which every weight inherits besides its own rounding. The
    history row is the carry's copy; a launch into the carry itself (in
    place) gives the same bits as one into new tensors; one launch a call."""
    from hygeia_tpu_torch.two_group.filter import _expand_and_weigh, _renormalise

    params, E_c, E_k, t, lw, parts, M, res = _k2_inputs(device, case)
    want_lw, want_parts, parents = _expand_and_weigh(params, E_c[..., t, :], E_k[..., t, :], lw, parts, M, res,
                                                     return_parents=True)
    want_lw, want_shift, want_degen = _renormalise(want_lw)
    before = k2.KERNEL.launches
    got_lw, got_parts, shifts, degen, hist, got_parents = _k2_launch(params, E_c, E_k, t, lw, parts, M, res)
    assert k2.KERNEL.launches == before + 1
    assert torch.equal(got_parts, want_parts)
    assert torch.equal(got_parents, parents)
    assert torch.equal(degen[:, t - 1], want_degen)
    assert torch.equal(torch.isneginf(got_lw), torch.isneginf(want_lw))
    assert torch.equal(torch.isfinite(got_lw), torch.isfinite(want_lw))
    fin = torch.isfinite(want_lw)
    torch.testing.assert_close(got_lw[fin], want_lw[fin], atol=2e-5, rtol=1e-6)
    torch.testing.assert_close(shifts[:, t - 1], want_shift, atol=2e-5, rtol=1e-6)
    others = [c for c in range(shifts.shape[1]) if c != t - 1]
    assert not shifts[:, others].any() and not degen[:, others].any()
    assert torch.equal(hist[0][:, t], got_lw)
    for h, f in zip(hist[1:], got_parts.unbind(1)):
        assert torch.equal(h[:, t], f.to(h.dtype))
    rows = [s for s in range(hist[0].shape[1]) if s != t]
    assert all(not h[:, rows].any() for h in hist)
    again = _k2_launch(params, E_c, E_k, t, lw.clone(), parts.clone(), M, res, out=None)
    carry = (lw.clone(), parts.clone())
    in_place = _k2_launch(params, E_c, E_k, t, *carry, M, res, out=carry)
    for a, b, c in zip(again[:4], in_place[:4], (got_lw, got_parts, shifts, degen)):
        assert torch.equal(a, c) and torch.equal(b, c)

    live = torch.isfinite(lw).sum(-1)
    if case == "no_resample":
        assert bool((live <= M).all()) and bool(torch.isneginf(lw.gather(1, parents)).any())
    elif case == "dead_ancestors":
        anc_dead = parts[:, 2].gather(1, parents) < 0
        assert bool((live > M).all()) and bool(anc_dead.any())
    elif case == "unbiased":
        assert bool((live > M).all())
    elif case == "all_dead":
        assert degen[:, t - 1].tolist() == [True, False]
        assert torch.equal(got_lw[0], torch.full_like(got_lw[0], -float(np.log(lw.shape[1]))))
    else:
        assert not degen.any()


def test_k2_refuses_what_it_cannot_take(device):
    """f64 weights (through the filter's site step too), a tensor that is
    not contiguous, an N that is not M * (2R + R^2), a unit beyond shared
    memory: each raises before a launch, and nothing falls back."""
    from hygeia_tpu_torch.two_group.filter import run_filter

    params, E_c, E_k, t, lw, parts, M, res = _k2_inputs(device, "cell")
    before = k2.KERNEL.launches
    with pytest.raises(TypeError, match="prev_lw has dtype"):
        _k2_launch(params, E_c, E_k, t, lw.double(), parts, M, res)
    with pytest.raises(ValueError, match="contiguous"):
        _k2_launch(params, E_c, E_k, t, lw, parts.transpose(1, 2).contiguous().transpose(1, 2), M, res)
    with pytest.raises(ValueError, match="N = M"):
        _k2_launch(params, E_c, E_k, t, lw[:, :-1].contiguous(), parts[..., :-1].contiguous(), M, res)
    big = 1200 * (2 * 6 + 36)
    with pytest.raises(ValueError, match="shared memory"):
        _k2_launch(params, E_c, E_k, t, torch.zeros((1, big), device=device),
                   torch.zeros((1, 5, big), dtype=torch.int32, device=device), 1200, res)
    with pytest.raises(TypeError):
        run_filter(params, E_c, E_k, M, n_units=2, generator=torch.Generator(device=device).manual_seed(0),
                   weight_dtype=torch.float64)
    assert k2.KERNEL.launches == before


@pytest.mark.parametrize("path", ["warm", "marginal", "streamed", "meshed", "simulator"])
def test_every_two_group_filter_path_on_the_card_launches_k2_with_k1(device, path, tmp_path):
    """Every filter site of a two-group path is K1 then K2 (filter_site): a
    warm-started run_filter, the marginal filter, streamed INFER, meshed
    INFER (per-unit generators and emission rows) and the simulator's
    self-test each launch K2 exactly as often as K1, at M = 50."""
    from hygeia_tpu_torch import cli
    from hygeia_tpu_torch.parallel import make_mesh, sharded_two_group_inference
    from hygeia_tpu_torch.two_group.filter import run_filter
    from hygeia_tpu_torch.two_group.marginal import run_marginal_filter
    from hygeia_tpu_torch.two_group.streaming import streamed_inference

    T, M, U = 120, 50, 2
    params = _k2_params(device, 6, T)
    E_c, E_k = _graph_tables(params, T, U, seed=5)
    gen = lambda s: torch.Generator(device=device).manual_seed(s)
    k1, k2_before = cr.KERNEL.launches, k2.KERNEL.launches
    if path == "warm":
        prev = run_filter(params, E_c, E_k, M, n_units=U, generator=gen(1), return_history=False)
        k1, k2_before = cr.KERNEL.launches, k2.KERNEL.launches
        run_filter(params, E_c, E_k, M, n_units=U, generator=gen(2),
                   init_state=(prev.log_weights, torch.stack(prev.particles, 1)))
        assert k2.KERNEL.launches - k2_before == T
    elif path == "marginal":
        run_marginal_filter(params, E_c[0], E_k[0], M, n_units=U, generator=gen(3))
        assert k2.KERNEL.launches - k2_before == T - 1
    elif path == "streamed":
        streamed_inference(params, E_c, E_k, M, 25, n_units=U, generator=gen(4), backward_generator=gen(5),
                           block_size=48)
    elif path == "meshed":
        rng = np.random.default_rng(3)
        n = rng.poisson(20, size=(200, 2)).astype(np.float32)
        y = np.minimum(rng.poisson(10, size=(200, 2)), n).astype(np.float32)
        sharded_two_group_inference(make_mesh(4, 2, device=device), _k2_params(device, 6, 200), y, n, y, n,
                                    segment_size=50, buffer_size=10, num_resampled_ancestors=M,
                                    num_samples_backward=25, seeds=[0, 1], boundary="exchange")
    else:
        out = cli.main(["simulate_two_groups", "--results_dir", str(tmp_path / "sim"), "--seed", "0", "--device",
                        "cuda", "--n_observations", str(T), "--run_inference"])
        assert out["N"] == M * 48 and k2.KERNEL.launches - k2_before == T - 1
    assert k2.KERNEL.launches - k2_before == cr.KERNEL.launches - k1 > 0


# ---- K3, the backward pass's site step (ops/cuda_backward_step.py) ----------

@pytest.mark.parametrize("U,T", [(2, 300), (32, 200)])
def test_k3_matches_the_plain_composition(device, U, T):
    """K3 against _backward_logits(history_layout=True) + the Gumbel
    transform + argmax on the card, site after site of a filter history at
    M = 50 (N = 2,400), B = 25, from the same carry and the same uniforms:
    the drawn states are equal on every row. A row that differed would have
    to be a tie: the plain version's largest noisy logit among the particles
    of K3's state within float32 rounding of the row's largest; the count of
    such rows is reported. Row t of the trajectories is the new carry, the
    index goes to t - 1 and its count back to 0; one launch a site."""
    from hygeia_tpu_torch.two_group import backward as bw
    from hygeia_tpu_torch.two_group.filter import run_filter
    from hygeia_tpu_torch.two_group.model import State

    M, B = 50, 25
    params = _k2_params(device, 6, T)
    E_c, E_k = _graph_tables(params, T, U, seed=U)
    res = run_filter(params, E_c, E_k, M, n_units=U, generator=torch.Generator(device=device).manual_seed(U))
    lw, parts = res.log_weights, res.particles
    N = lw.shape[-1]
    st = params.step_tables()
    g = torch.Generator(device=device).manual_seed(17)
    u = torch.empty((U, B, N), device=device)
    term = bw._categorical_rows(lw[:, T - 1, None, :], bw._noise(torch.rand(u.shape, generator=g, device=device)))
    nxt = torch.stack([f[:, T - 1].gather(1, term).to(torch.int32) for f in parts], dim=-1)
    traj = torch.zeros((U, T, B, 5), dtype=torch.int32, device=device)
    idx = torch.tensor([T - 2, 0], device=device)
    ties = 0
    for t in range(T - 2, -1, -1):
        torch.rand(u.shape, generator=g, out=u)
        cur = State(*(f[:, t] for f in parts))
        v = bw._noise(u) + bw._backward_logits(params, cur, State(*nxt.unbind(-1)), lw[:, t], history_layout=True)
        want = torch.stack([f.gather(1, v.argmax(-1)).to(torch.int32) for f in cur], dim=-1)
        got = nxt.clone()
        before = k3.KERNEL.launches
        k3.backward_step_cuda(idx, (lw, *parts), u, got, traj, st.rho_both, params.log_p_control,
                              params.log_p_merged, params.min_duration)
        assert k3.KERNEL.launches == before + 1
        assert idx.tolist() == [t - 1, 0]
        assert torch.equal(traj[:, t], got)
        differ = (got != want).any(-1)
        if bool(differ.any()):
            state = torch.stack([f.to(torch.int32) for f in cur], dim=-1)  # (U, N, 5)
            mine = (state[:, None] == got[:, :, None]).all(-1)  # (U, B, N): particles of K3's state
            best = torch.where(mine, v, float("-inf")).amax(-1)[differ].double()
            top = v.amax(-1)[differ].double()
            assert bool(((top - best).abs() <= 4 * torch.finfo(torch.float32).eps * top.abs()).all()), (
                f"site {t}: K3's draw is not a float32 tie with the plain version's")
            ties += int(differ.sum())
        nxt = got
    print(f"K3 vs plain at U={U}: {(T - 1) * U * B} rows, {ties} drawn differently (float32 ties)")
    assert ties == 0 or ties <= 1e-3 * (T - 1) * U * B


def test_k3_refuses_what_it_cannot_take(device):
    """f64 weights (through the backward pass too), a history that is not
    contiguous, an N that is not M * (2R + R^2), a row beyond shared
    memory, injected noise: each raises before a launch; nothing falls
    back."""
    from hygeia_tpu_torch.two_group.backward import backward_simulation

    U, T, B, R = 2, 4, 3, 6
    params = _k2_params(device, R, T)
    st = params.step_tables()

    def launch(N, lw_dtype=torch.float32, hist_slice=False):
        hist = [torch.zeros((U, T, N), dtype=dt, device=device) for dt in k2.HISTORY_DTYPES]
        hist[0] = hist[0].to(lw_dtype)
        if hist_slice:
            hist[0] = torch.zeros((U, T, 2 * N), device=device)[..., :N]
        k3.backward_step_cuda(torch.tensor([T - 1, 0], device=device), hist,
                              torch.zeros((U, B, N), device=device), torch.zeros((U, B, 5), dtype=torch.int32,
                                                                                 device=device),
                              torch.zeros((U, T, B, 5), dtype=torch.int32, device=device), st.rho_both,
                              params.log_p_control, params.log_p_merged, params.min_duration)

    before = k3.KERNEL.launches
    with pytest.raises(TypeError, match=r"hist\[0\] has dtype"):
        launch(2400, torch.float64)
    with pytest.raises(ValueError, match="contiguous"):
        launch(2400, hist_slice=True)
    with pytest.raises(ValueError, match="N = M"):
        launch(2401)
    with pytest.raises(ValueError, match="shared memory"):
        launch(20_000 * 48)
    parts = [torch.zeros((U, T, 2400), dtype=dt, device=device) for dt in k2.HISTORY_DTYPES[1:]]
    with pytest.raises(TypeError):
        backward_simulation(params, torch.zeros((U, T, 2400), dtype=torch.float64, device=device), parts, B,
                            generator=torch.Generator(device=device).manual_seed(0))
    with pytest.raises(ValueError, match="CPU-only"):
        backward_simulation(params, torch.zeros((U, T, 2400), device=device), parts, B, noise=lambda t: None)
    assert k3.KERNEL.launches == before


def _count_backward_sites(monkeypatch):
    """Patch backward_simulation_conditioned wherever a path takes it from
    (backward_simulation calls it too) to add each call's backward sites,
    T - 1 and one more for a conditioned terminal draw, to the list's one
    entry."""
    from hygeia_tpu_torch.parallel import sharded
    from hygeia_tpu_torch.two_group import backward as bw
    from hygeia_tpu_torch.two_group import streaming

    sites = [0]
    orig = bw.backward_simulation_conditioned

    def counted(params, log_weights, particles, terminal_state, use_terminal, **kw):
        sites[0] += log_weights.shape[1] - 1 + (use_terminal is not False)
        return orig(params, log_weights, particles, terminal_state, use_terminal, **kw)

    for mod in (bw, streaming, sharded):
        monkeypatch.setattr(mod, "backward_simulation_conditioned", counted)
    return sites


@pytest.mark.parametrize("path", ["monolithic", "streamed", "meshed_halo", "meshed_exchange", "simulator",
                                  "marginal"])
def test_every_two_group_backward_path_on_the_card_launches_k3_once_a_site(device, path, tmp_path, monkeypatch):
    """Every backward site of a two-group path is one K3 launch: INFER's
    monolithic call (infer_segment), streamed INFER, meshed INFER with both
    boundaries (per-unit generators, conditioned and mixed terminal draws)
    and the simulator's self-test; the marginal filter draws none."""
    from hygeia_tpu_torch import cli
    from hygeia_tpu_torch.parallel import make_mesh, sharded_two_group_inference
    from hygeia_tpu_torch.two_group.marginal import run_marginal_filter
    from hygeia_tpu_torch.two_group.runner import infer_segment
    from hygeia_tpu_torch.two_group.streaming import streamed_inference

    sites = _count_backward_sites(monkeypatch)
    T, M, U = 120, 50, 2
    params = _k2_params(device, 6, T)
    E_c, E_k = _graph_tables(params, T, U, seed=5)
    gen = lambda s: torch.Generator(device=device).manual_seed(s)
    before = k3.KERNEL.launches
    if path == "monolithic":
        infer_segment(results_dir=str(tmp_path / "out"), device=device, seed=[0, 1], **_infer_dataset(tmp_path, T))
        assert sites[0] == T - 1
    elif path == "streamed":
        streamed_inference(params, E_c, E_k, M, 25, n_units=U, generator=gen(4), backward_generator=gen(5),
                           block_size=48)
        assert sites[0] == T - 1
    elif path.startswith("meshed"):
        rng = np.random.default_rng(3)
        n = rng.poisson(20, size=(200, 2)).astype(np.float32)
        y = np.minimum(rng.poisson(10, size=(200, 2)), n).astype(np.float32)
        sharded_two_group_inference(make_mesh(4, 2, device=device), _k2_params(device, 6, 200), y, n, y, n,
                                    segment_size=50, buffer_size=10, num_resampled_ancestors=M,
                                    num_samples_backward=25, seeds=[0, 1], boundary=path[len("meshed_"):])
    elif path == "simulator":
        cli.main(["simulate_two_groups", "--results_dir", str(tmp_path / "sim"), "--seed", "0", "--device",
                  "cuda", "--n_observations", str(T), "--run_inference"])
        assert sites[0] == T - 1
    else:
        run_marginal_filter(params, E_c[0], E_k[0], M, n_units=U, generator=gen(3))
        assert sites[0] == 0
    assert k3.KERNEL.launches - before == sites[0]
    assert (sites[0] > 0) == (path != "marginal")


@pytest.mark.parametrize("kappa_fixed", [True, False])
def test_hazard_tables_bit_identical_to_the_cpu(device, kappa_fixed):
    from hygeia_tpu_torch.single_group.model import build_tables, make_model

    R = 6
    theta = np.random.default_rng(3).normal(size=R * R + (0 if kappa_fixed else R))
    got = {}
    for dev in (torch.device("cpu"), device):
        model = make_model([0.99, 0.01, 0.8, 0.2, 0.5, 0.5], [0.05, 0.05, 0.2, 0.2, 0.2, 0.2886751],
                           2, np.full(R, 2.0), kappa_fixed=kappa_fixed, d_max=4096, device=dev)
        got[dev.type] = build_tables(model, torch.tensor(theta, dtype=torch.float32, device=dev))
    for name in ("rho", "exit_status", "grad_omega_log_rho", "grad_kappa_log_rho"):
        assert torch.equal(getattr(got["cpu"], name), getattr(got["cuda"], name).cpu()), name


def test_single_group_engine_on_the_card_goes_through_the_kernel(device):
    from hygeia_tpu_torch.ops.emissions import emission_log_prob_table
    from hygeia_tpu_torch.single_group.engine import EngineConfig, run_online_combined_inference
    from hygeia_tpu_torch.single_group.model import make_model, parameters_to_theta

    R, T = 6, 500
    rng = np.random.default_rng(2)
    model = make_model([0.99, 0.01, 0.8, 0.2, 0.5, 0.5], [0.05, 0.05, 0.2, 0.2, 0.2, 0.2886751],
                       2, np.full(R, 2.0), device=device)
    p = np.full((R, R), 1.0 / (R - 1))
    np.fill_diagonal(p, 0.0)
    theta = parameters_to_theta(p, [0.995, 0.975, 0.95, 0.925, 0.9, 0.9])
    n = rng.poisson(20, size=(T, 2))
    y = rng.binomial(n, np.repeat(rng.uniform(0, 1, T // 50), 50)[:, None])
    E = emission_log_prob_table(y, n, model.alpha, model.beta)
    cfg = EngineConfig(estimate_parameters=True, steps_per_update=50)
    before = cr.KERNEL.launches
    res = run_online_combined_inference(
        model, theta, E, cfg, n_units=2, generator=torch.Generator(device=device).manual_seed(0)
    )
    assert cr.KERNEL.launches - before >= T - 1
    assert bool(torch.isfinite(res.log_normalizing_constant).all())
    assert bool(torch.isfinite(res.theta_trace).all())
    assert bool(res.regime_valid.all())
    torch.testing.assert_close(res.regime_probs.sum(-1), torch.ones((2, T), device=device), atol=1e-4, rtol=0)


def _k4_engine(device, case, T=600, units=None):
    """An _Engine on the card at the θ cell's widths (N = 250, S = 128, R =
    6, u = 3), updates every 200 sites, for a K4 case: "cell" (U = 1, one
    shared table, both estimates), "u4_per_unit" (U = 4, a table a unit),
    "no_regimes", "kappa_free" (D = 42), "frozen", "frozen_update" and
    "t_limit_ends" (U = 4 with t_limit (T, 300, T, 200)), "update", "last"
    and "chunked"."""
    from hygeia_tpu_torch.ops.emissions import emission_log_prob_table
    from hygeia_tpu_torch.single_group.engine import EngineConfig, _Engine
    from hygeia_tpu_torch.single_group.model import make_model, parameters_to_theta

    R = 6
    U = units or (4 if case in ("u4_per_unit", "frozen", "frozen_update", "t_limit_ends") else 1)
    kappa_fixed = case != "kappa_free"
    model = make_model([0.95, 0.05, 0.8, 0.2, 0.5, 0.5], [0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751], 3,
                       np.full(R, 2.0), device=device, kappa_fixed=kappa_fixed)
    p = np.full((R, R), 1.0 / (R - 1))
    np.fill_diagonal(p, 0.0)
    theta = parameters_to_theta(p, [0.995, 0.975, 0.95, 0.925, 0.9, 0.9], np.full(R, 2.0), kappa_fixed)
    rng = np.random.default_rng(U * 7 + len(case))
    tables = []
    for _ in range(U if U > 1 else 1):
        n = rng.poisson(20, size=(T, 2))
        y = rng.binomial(n, np.repeat(rng.uniform(0, 1, T // 50), 50)[:, None])
        tables.append(emission_log_prob_table(y, n, model.alpha, model.beta))
    E = torch.stack(tables) if U > 1 else tables[0]
    cfg = EngineConfig(estimate_regimes=case != "no_regimes", estimate_parameters=True, steps_per_update=200)
    t_limit = [T, 300, T, 200] if case in ("frozen", "frozen_update", "t_limit_ends") else None
    return _Engine(model, theta, E, cfg, U, torch.float32, t_limit=t_limit)


def _k4_snapshot(eng):
    """Copies of every tensor the site step reads or writes."""
    snap = {k: v.clone() for k, v in eng.state.items() if torch.is_tensor(v)}
    snap.update(haz=eng.haz.clone(), log_P=eng.log_P.clone(), P=eng.P.clone(), t_dev=eng.t_dev.clone())
    return snap


def _k4_restore(eng, snap):
    for k, v in snap.items():
        (eng.state[k] if k in eng.state else getattr(eng, k)).copy_(v)


def _k4_gap(a, b, scale=None):
    """(max |a - b|, the largest |a - b| / (2e-6 + 2e-5 s)) where both are
    finite, s being |b| element by element or ``scale`` (broadcast to b):
    the size of the values an element is summed from. The non-finite
    entries must be equal (NaN to NaN). Within tolerance where the second
    is at most 1."""
    a, b = a.double(), b.double()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    assert torch.equal(fa, fb) and torch.equal(a[~fa].nan_to_num(0.0), b[~fb].nan_to_num(0.0))
    if not bool(fa.any()):
        return 0.0, 0.0
    s = b.abs() if scale is None else scale.double().abs().expand_as(b)
    err = (a - b).abs()[fa]
    return float(err.max()), float((err / (2e-6 + 2e-5 * s[fa])).max())


def _k4_gaps(got, want, t0, T):
    """_k4_gap of every value of the site step (snapshots of the K4 and
    the plain route), each against the size it is summed from: psi by its
    regime rows, phi by its columns, the score and the ADAM moments by
    phi's columns, θ and the tables by their rows. Site t0 of T; the
    trace's rows past t0 are not written yet, out's sentinel row T is
    never read."""
    row = lambda x: x.abs().amax(-1, keepdim=True)
    phi_col = want["phi"].abs().amax(1)  # (U, D)
    scales = {"psi": row(want["psi"]), "phi": want["phi"].abs().amax(1, keepdim=True), "score": phi_col,
              "grad_prev": phi_col, "adam_m": phi_col, "adam_v": phi_col**2, "theta": row(want["theta"]),
              "haz": row(want["haz"])}
    gaps = {k: _k4_gap(got[k], want[k], scales.get(k))
            for k in ("w", "shifts", "psi", "phi", "score", "theta", "grad_prev", "adam_m", "adam_v", "haz",
                      "log_P", "P")}
    trace = (got["trace"][:, :t0 + 1], want["trace"][:, :t0 + 1])
    gaps["trace"] = _k4_gap(*trace, row(trace[1]))
    gaps["out"] = _k4_gap(got["out"][:, :T], want["out"][:, :T])
    return gaps


@pytest.mark.parametrize("case", ["cell", "u4_per_unit", "no_regimes", "kappa_free", "frozen", "frozen_update",
                                  "t_limit_ends", "update", "last", "chunked"])
def test_k4_matches_the_plain_composition(device, case, tmp_path):
    """One site through K4 against the plain composition (_step_plain) on
    the card from the same state and the same uniforms, after a run of K4
    sites: the particles, ancestors, insertion slots, finalisations and
    counts equal; the weights, shifts, psi, phi, the score, θ, the ADAM
    moments, the tables and the finalised rows within 2e-6 + 2e-5 s
    (``_k4_gaps``: f32 sums of N = 250 terms taken in another order than
    torch.logsumexp's and cuBLAS's); K4 launches once a stage. Cases: the θ cell's shape; U = 4 with a table a unit; the
    regime pass off; κ estimated (D = 42); units past their t_limit, at a
    steady and an update site (their ADAM state kept); the site where two
    units' t_limit ends (their entries all finalise); an update site (ADAM
    and the rebuilt tables after K4's GRADIENT); the last site; and an
    engine resumed from a chunked run's checkpoint."""
    from hygeia_tpu_torch.ops import cuda_engine_step as k4
    from hygeia_tpu_torch.single_group.engine import _site_uniforms

    T = 600
    t0 = {"frozen": 350, "frozen_update": 400, "t_limit_ends": 299, "update": 400, "last": T - 1}.get(case, 321)
    eng = _k4_engine(device, case, T)
    assert eng.k4 and eng.takes_k4(t0) and not eng.takes_k4(40) and eng.takes_k4(41)
    g = torch.Generator(device=device).manual_seed(11)
    for t in range(1, t0):
        eng.step(t, *_site_uniforms(eng.U, eng.M, g, device))
    if case == "chunked":
        path = tmp_path / "ck.npz"
        eng.state["next_t"] = t0
        eng.save(path)
        eng = _k4_engine(device, case, T)
        with np.load(path, allow_pickle=False) as ck:
            eng.load(ck)
        assert eng.t_dev.tolist() == [t0]
    draws = _site_uniforms(eng.U, eng.M, g, device)
    snap = _k4_snapshot(eng)
    launches = k4.KERNEL.launches
    eng.step(t0, *draws)
    stages = 2 if case == "no_regimes" else 3  # WEIGHTS, SMOOTH with the regime pass, GRADIENT
    assert k4.KERNEL.launches == launches + stages
    got = _k4_snapshot(eng)
    _k4_restore(eng, snap)
    eng.k4 = False
    eng.step(t0, *draws)
    want = _k4_snapshot(eng)
    assert k4.KERNEL.launches == launches + stages
    for k in ("d", "r", "psi_time", "psi_valid", "spill", "adam_iter", "t_dev"):
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["out_valid"][:, :T], want["out_valid"][:, :T])
    gaps = _k4_gaps(got, want, t0, T)
    print(f"K4 vs plain, {case} at t={t0}: max abs err " + ", ".join(f"{k} {v[0]:.2e}" for k, v in gaps.items())
          + "; of tolerance " + ", ".join(f"{k} {v[1]:.2f}" for k, v in gaps.items()))
    assert max(v[1] for v in gaps.values()) <= 1, gaps


def test_k4_refuses_what_it_cannot_take(device):
    """A CUDA engine with f64 weights or wider than K4's bounds is refused
    when it is made, naming the bound (nothing on the card falls back to
    the plain composition); a CPU engine takes the plain composition; a
    launch with a tensor of another dtype or shape raises before it is
    made, naming the tensor."""
    from hygeia_tpu_torch.ops import cuda_engine_step as k4
    from hygeia_tpu_torch.ops.cuda_resampling import optimal_resampling
    from hygeia_tpu_torch.single_group.engine import EngineConfig, _Engine, _site_uniforms
    from hygeia_tpu_torch.single_group.model import make_model

    eng = _k4_engine(device, "cell", T=100)
    assert eng.k4
    model = make_model([0.95, 0.05, 0.8, 0.2, 0.5, 0.5], [0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751], 3,
                       np.full(6, 2.0), device=device)
    with pytest.raises(TypeError, match="float32 weights, got torch.float64"):
        _Engine(model, eng.state["theta"][0].double(), eng.emissions[0].double(), eng.config, 1, torch.float64)
    with pytest.raises(ValueError, match="shared memory"):
        _Engine(model, eng.state["theta"][0], eng.emissions[0], EngineConfig(n_particles_max=3300), 1,
                torch.float32)
    assert not _k4_engine(torch.device("cpu"), "cell", T=100).k4
    res = optimal_resampling(eng.state["w"], eng.M, *_site_uniforms(1, eng.M, torch.Generator(device=device), device))

    def launch(**change):
        state = {**eng.state, **change}
        k4.engine_step_cuda(k4.WEIGHTS, state, res, (eng.haz, eng.log_P, eng.P), eng.emissions, eng.k4_ws,
                            eng.t_dev, min_duration=3, epsilon=0.01)

    before = k4.KERNEL.launches
    with pytest.raises(TypeError, match=r"state\['w'\] has dtype"):
        launch(w=eng.state["w"].double())
    with pytest.raises(TypeError, match=r"state\['d'\] has dtype"):
        launch(d=eng.state["d"].int())
    with pytest.raises(ValueError, match=r"state\['psi'\] has shape"):
        launch(psi=eng.state["psi"][:, :, :5])
    with pytest.raises(ValueError, match=r"state\['phi'\] must be contiguous"):
        launch(phi=eng.state["phi"].transpose(1, 2).contiguous().transpose(1, 2))
    assert k4.KERNEL.launches == before


def test_k4_engine_graphed_equals_eager_and_counts_its_sites(device):
    """The θ cell's engine (U = 1, N = 250, both estimates, updates every
    200 sites) over 1,000 sites on the card: replayed as graphs of 8 sites
    (update sites one-site graphs) it equals the eager run bit for bit;
    K4 launches three times a site at capacity on either route (WEIGHTS,
    SMOOTH and GRADIENT at T - 1 - 40 sites: the 40 growth sites take the
    plain composition) and K1 once a site; a replayed steady site runs at
    most 10 graph nodes."""
    from hygeia_tpu_torch.ops import cuda_engine_step as k4
    from hygeia_tpu_torch.single_group.engine import _run_sites, _site_draws
    from hygeia_tpu_torch.ops.site_graphs import SiteLoop
    from hygeia_tpu_torch.utils import spans

    T = 1000
    out = {}
    for K in (0, 8):
        eng = _k4_engine(device, "cell", T)
        g = torch.Generator(device=device).manual_seed(5)
        capacity = sum(eng.takes_k4(t) for t in range(1, T))
        assert capacity == T - 1 - 40
        before, k1_before = k4.KERNEL.launches, cr.KERNEL.launches
        spans.enable()
        try:
            with SiteLoop(device, K, g) as loop:
                _run_sites(eng, loop, 1, T, _site_draws(eng, None, None, g))
            torch.cuda.synchronize(device)
        finally:
            recorded, _ = spans.drain()
            spans.disable()
        assert k4.KERNEL.launches - before == 3 * capacity
        assert cr.KERNEL.launches - k1_before == T - 1
        out[K] = {k: v.clone() for k, v in eng.state.items() if torch.is_tensor(v)}
        if K:
            steady = [s for s in recorded if s.name == "site_loop.capture" and s.attrs.get("kind") == "steady"
                      and s.attrs.get("sites") == K]
            assert steady, "no steady graph of 8 sites was captured"
            per_site = steady[0].attrs["nodes"] / K
            print(f"K4: {per_site:.1f} nodes a replayed steady site")
            assert per_site <= 10
    for k in out[0]:
        assert torch.equal(out[0][k], out[8][k]), k


def test_xla_f32_functions_bit_identical_to_the_cpu(device):
    """ops/xla_f32.py's exp, log, log1p, lgamma, digamma (XLA's CPU f32
    kernels replayed, FMAs by exact emulation): the card's bits are the
    CPU's on the tables' arguments and a broad sweep."""
    from hygeia_tpu_torch.ops import xla_f32

    rng = np.random.default_rng(5)
    d = np.arange(4096, dtype=np.float32)
    lg = np.concatenate([d + 2.0, d + 1.0, rng.uniform(0.5, 1e4, 50000)]).astype(np.float32)
    args = {
        "exp": (rng.normal(size=50000) * 40).astype(np.float32),
        "log": np.exp(rng.normal(size=50000) * 20).astype(np.float32),
        "log1p": rng.uniform(-0.99, 3, 50000).astype(np.float32),
        "lgamma": lg,
        "digamma": lg,
    }
    for name, x in args.items():
        fn = getattr(xla_f32, name)
        cpu = fn(torch.from_numpy(x))
        card = fn(torch.from_numpy(x).to(device)).cpu()
        assert torch.equal(cpu.view(torch.int32), card.view(torch.int32)), name


def test_streamed_equals_monolithic_on_the_card(device):
    """T=300, W=64 (5 blocks), U=4, f32 at the production width M=50: the
    streamed trajectories and logZ are the monolithic ones bit for bit,
    every re-run equals its checkpoint, and the kernel runs
    2T - len_last - 2 times."""
    from hygeia_tpu_torch.ops.emissions import emission_log_prob_table
    from hygeia_tpu_torch.two_group.backward import backward_simulation
    from hygeia_tpu_torch.two_group.filter import run_filter
    from hygeia_tpu_torch.two_group.model import make_params
    from hygeia_tpu_torch.two_group.streaming import launches_per_call, streamed_inference

    R, T, M, B, U, W = 6, 300, 50, 25, 4, 64
    rng = np.random.default_rng(3)
    params = make_params(
        mu=[0.95, 0.05, 0.80, 0.20, 0.50, 0.50], sigma=[0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751],
        p_softmax_control=np.zeros((R, R)), omega_logit_control=np.full(R, 4.0), omega_case=0.8,
        kappa_control=np.full(R, 2.0), kappa_case=np.full(R, 2.0), merge_log_prob=np.log(0.1),
        split_prob=0.01, minimum_duration=3, d_max=T + 1, device=device,
    )
    n = rng.poisson(20, size=(T, 2))
    E_c = emission_log_prob_table(rng.binomial(n, 0.7), n, params.alpha, params.beta)
    E_k = emission_log_prob_table(rng.binomial(n, 0.3), n, params.alpha, params.beta)

    def gen(s):
        return torch.Generator(device=device).manual_seed(s)

    res = run_filter(params, E_c, E_k, M, n_units=U, generator=gen(1))
    traj = backward_simulation(params, res.log_weights, res.particles, B, generator=gen(2)).cpu().numpy()
    timings = {}
    before = cr.KERNEL.launches
    got, log_z, degen = streamed_inference(params, E_c, E_k, M, B, n_units=U, generator=gen(1),
                                           backward_generator=gen(2), block_size=W, timings=timings)
    assert cr.KERNEL.launches - before == launches_per_call(T, W) == 2 * T - (T - 4 * W) - 2
    np.testing.assert_array_equal(got, traj)
    assert torch.equal(log_z, res.log_normalizing_constant)
    assert torch.equal(degen, res.degenerate_steps)
    assert timings["rerun_equals_checkpoint"] == [True] * 4


def test_robust_table_on_the_card_matches_the_cpu(device):
    """The f32 robust table built on the card (lgamma and exp of the card)
    against the f64 table on the CPU: rtol 1e-5."""
    from hygeia_tpu_torch.ops.distributions import mu_sigma_to_alpha_beta
    from hygeia_tpu_torch.ops.emissions import robust_emission_log_prob_table

    rng = np.random.default_rng(5)
    n = rng.poisson(20, size=(2000, 2)).astype(np.float64)
    y = rng.binomial(n.astype(int), 0.4).astype(np.float64)
    tables = []
    for dev, dtype in ((torch.device("cpu"), torch.float64), (device, torch.float32)):
        a, b = mu_sigma_to_alpha_beta(torch.tensor([0.95, 0.05, 0.8, 0.2, 0.5, 0.5], dtype=dtype, device=dev),
                                      torch.tensor([0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751], dtype=dtype, device=dev))
        tables.append(robust_emission_log_prob_table(y, n, a, b, dtype=dtype).cpu().double())
    torch.testing.assert_close(tables[1], tables[0], rtol=1e-5, atol=0)
    a, b = mu_sigma_to_alpha_beta(torch.tensor([0.95, 0.05, 0.8, 0.2, 0.5, 0.5], dtype=torch.float32),
                                  torch.tensor([0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751], dtype=torch.float32))
    cpu32 = robust_emission_log_prob_table(y, n, a, b)
    assert torch.equal(cpu32.double(), tables[1])


def test_blocked_theta_on_the_card_launches_once_a_site_for_all_blocks(device):
    """The warmup chain, then every block as a unit of one engine call: the
    kernel launched (Tw - 1) + (win - 1) times."""
    from hygeia_tpu_torch.ops.emissions import emission_log_prob_table
    from hygeia_tpu_torch.single_group.blocked import run_online_combined_inference_blocked
    from hygeia_tpu_torch.single_group.engine import EngineConfig
    from hygeia_tpu_torch.single_group.model import make_model

    R, T = 6, 1000
    rng = np.random.default_rng(6)
    model = make_model([0.99, 0.01, 0.8, 0.2, 0.5, 0.5], [0.05, 0.05, 0.2, 0.2, 0.2, 0.2886751],
                       2, np.full(R, 2.0), device=device)
    n = rng.poisson(20, size=(T, 2))
    y = rng.binomial(n, np.repeat(rng.uniform(0, 1, T // 50), 50)[:, None])
    E = emission_log_prob_table(y, n, model.alpha, model.beta)
    cfg = EngineConfig(estimate_parameters=True, steps_per_update=50)
    before = cr.KERNEL.launches
    res = run_online_combined_inference_blocked(model, np.zeros(R * R), E, cfg, block_size=256, halo=64,
                                                warmup_sites=200,
                                                generator=torch.Generator(device=device).manual_seed(0))
    assert cr.KERNEL.launches - before == (200 - 1) + (256 + 64 - 1)
    assert np.isfinite(res.theta_trace).all() and res.regime_valid.all()


@pytest.mark.parametrize("S", [2, 8])
def test_f32_emission_table_and_rho_bit_identical_to_the_cpu(device, S):
    """The f32 BetaBinomial table at the infer and the single-group defaults
    (shapes below 0.5: the lgamma reflection through the replayed sin) and
    the two-group rho for six omega: the card's bits are the CPU's."""
    from hygeia_tpu_torch.ops import xla_f32
    from hygeia_tpu_torch.ops.distributions import mu_sigma_to_alpha_beta
    from hygeia_tpu_torch.ops.emissions import emission_log_prob_table
    from hygeia_tpu_torch.ops.hazard import rho_two_group

    rng = np.random.default_rng(S)
    n = rng.poisson(20, size=(3000, S)).astype(np.float32)
    n[::13] = 0
    y = np.minimum(rng.poisson(10, size=n.shape), n).astype(np.float32)
    for mu, sigma in (([0.95, 0.05, 0.80, 0.20, 0.50, 0.50], [0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751]),
                      ([0.99, 0.01, 0.80, 0.20, 0.50, 0.50], [0.05, 0.05, 0.20, 0.20, 0.20, 0.2886751])):
        tabs = []
        for dev in (torch.device("cpu"), device):
            a, b = mu_sigma_to_alpha_beta(torch.tensor(mu, dtype=torch.float32, device=dev),
                                          torch.tensor(sigma, dtype=torch.float32, device=dev))
            tabs.append(emission_log_prob_table(y, n, a, b).cpu())
        assert torch.equal(tabs[0], tabs[1])
    omega = torch.tensor([0.8, 1 / (1 + np.exp(-2.0)), 1 / (1 + np.exp(2.0)), 0.995, 0.975, 0.9],
                         dtype=torch.float32)
    kappa = torch.full((6,), 2.0)
    assert torch.equal(rho_two_group(kappa, omega, 3, 4096),
                       rho_two_group(kappa.to(device), omega.to(device), 3, 4096).cpu())
    x = torch.from_numpy(rng.uniform(0, np.pi / 2, 100000).astype(np.float32))
    assert torch.equal(xla_f32.sin(x), xla_f32.sin(x.to(device)).cpu())


def test_single_group_pipeline_on_the_card_matches_the_cpu(device, tmp_path):
    """run_single_group over one preprocessed chromosome of two samples
    (300 sites, N=250): both batched passes on the card, 2 (T - 1)
    launches; the regime probabilities within the module's bounds of the
    CPU run's."""
    from hygeia_tpu_torch.pipeline.orchestrator import run_single_group
    from hygeia_tpu_torch.utils import io as hio

    T = 300
    rng = np.random.default_rng(8)
    level = np.repeat(rng.choice([0.97, 0.03, 0.5], size=T // 30), 30)
    samples = []
    for sid in ("a", "b"):
        pre = tmp_path / "pre" / sid
        n = rng.poisson(25, size=(T, 2))
        hio.write_count_matrix(pre / "positions_c.txt.gz", np.arange(1, T + 1) * 13)
        hio.write_count_matrix(pre / "n_total_reads_case_c.txt.gz", n)
        hio.write_count_matrix(pre / "n_methylated_reads_case_c.txt.gz", rng.binomial(n, level[:, None]))
        samples.append((sid, pre))
    probs = []
    for i, dev in enumerate((torch.device("cpu"), device)):
        before = cr.KERNEL.launches
        out = run_single_group(output_dir=tmp_path / str(i), chroms=["c"], samples=samples, device=dev)
        if dev.type == "cuda":
            assert cr.KERNEL.launches - before == 2 * (T - 1)
        probs.append([hio.read_headed_table(out / "3_ESTIMATE_REGIMES" / sid / "c" /
                                            "regime_probabilities_c.csv.gz")[1][:, 1:] for sid in ("a", "b")])
    for p_cpu, p_card in zip(*probs):
        assert float(np.abs(p_cpu - p_card).mean()) < 0.05
        sure = (p_cpu.max(1) > 0.9) & (p_card.max(1) > 0.9)
        assert float((p_cpu.argmax(1) == p_card.argmax(1))[sure].mean()) >= 0.9


def test_marginal_filter_on_the_card_matches_the_cpu(device):
    """run_marginal_filter at M=50 (N=2400), f32, two units, the same
    injected uniforms on both devices: T - 1 launches on the card, and the
    functionals and logZ within the module's bounds of the CPU's."""
    from hygeia_tpu_torch.ops.emissions import emission_log_prob_table
    from hygeia_tpu_torch.two_group.marginal import run_marginal_filter
    from hygeia_tpu_torch.two_group.model import make_params

    R, T, M, U = 6, 200, 50, 2
    rng = np.random.default_rng(9)
    n = rng.poisson(20, size=(T, 2))
    y_c, y_k = rng.binomial(n, 0.7), rng.binomial(n, np.where(np.arange(T) % 100 < 40, 0.1, 0.7)[:, None])
    g = torch.Generator().manual_seed(5)
    u_sys, u_mult = torch.rand((U, T - 1), generator=g), torch.rand((U, T - 1, M), generator=g)
    out = []
    for dev in (torch.device("cpu"), device):
        params = make_params(
            mu=[0.95, 0.05, 0.80, 0.20, 0.50, 0.50], sigma=[0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751],
            p_softmax_control=np.zeros((R, R)), omega_logit_control=np.full(R, 4.0), omega_case=0.8,
            kappa_control=np.full(R, 2.0), kappa_case=np.full(R, 2.0), merge_log_prob=np.log(0.1),
            split_prob=0.01, minimum_duration=3, d_max=T + 1, device=dev,
        )
        E_c = emission_log_prob_table(y_c, n, params.alpha, params.beta)
        E_k = emission_log_prob_table(y_k, n, params.alpha, params.beta)
        before = cr.KERNEL.launches
        res = run_marginal_filter(params, E_c, E_k, M, n_units=U, uniforms=(u_sys.to(dev), u_mult.to(dev)),
                                  phantom_regime=0)
        out.append(res)
        if dev.type == "cuda":
            assert cr.KERNEL.launches - before == T - 1
    a, b = out
    assert bool(b.valid.all()) and int(b.degenerate_steps.sum()) == 0
    torch.testing.assert_close(b.functionals.cpu(), a.functionals, atol=0.02, rtol=0)
    torch.testing.assert_close(b.log_normalizing_constant.cpu(), a.log_normalizing_constant, rtol=1e-4, atol=0)


@pytest.mark.parametrize("R", [6, 5])
def test_two_group_simulator_on_the_card_equals_the_cpu(device, R):
    """The chain with the same injected noise on both devices: the same
    states (the float32 hazard tables are bit-identical and the jumps and
    Gumbel-max draws are exact comparisons); the counts on the card within
    their depths."""
    from hygeia_tpu_torch.two_group import simulate as sim
    from hygeia_tpu_torch.two_group.model import make_params

    T = 600
    noise = sim.draw_chain_noise(T, R, generator=torch.Generator().manual_seed(R), device="cpu")
    states = []
    for dev in (torch.device("cpu"), device):
        params = make_params(
            mu=[0.95, 0.05, 0.80, 0.20, 0.50, 0.50][:R], sigma=[0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751][:R],
            p_softmax_control=np.random.default_rng(1).normal(size=(R, R)), omega_logit_control=np.full(R, 1.2),
            omega_case=0.8, kappa_control=np.full(R, 2.0), kappa_case=np.full(R, 2.0), merge_log_prob=np.log(0.1),
            split_prob=0.01, minimum_duration=3, d_max=T + 1, device=dev,
        )
        states.append(sim.simulate_chain(params, noise).cpu())
        n = torch.full((T, 2), 20.0, device=dev)
        res = sim.simulate(params, n, n, generator=torch.Generator(device=dev).manual_seed(0))
        assert res.obs_control.device == dev and bool(((res.obs_case >= 0) & (res.obs_case <= 20)).all())
    assert torch.equal(states[0], states[1])
    assert 0 < float((states[0][:, 0] == 0).float().mean()) < 1


def test_single_group_simulator_on_the_card_equals_the_cpu(device):
    from hygeia_tpu_torch.single_group import simulate as sim
    from hygeia_tpu_torch.single_group.model import make_model, parameters_to_theta
    from hygeia_tpu_torch.single_group.runner import DEFAULT_MU, DEFAULT_OMEGA, DEFAULT_SIGMA, default_p

    T, R = 800, 6
    noise = sim.draw_chain_noise(T, R, generator=torch.Generator().manual_seed(3), device="cpu")
    theta = parameters_to_theta(default_p(R), np.asarray(DEFAULT_OMEGA), np.full(R, 2.0))
    out = []
    for dev in (torch.device("cpu"), device):
        model = make_model(np.asarray(DEFAULT_MU), DEFAULT_SIGMA, 2, np.full(R, 2.0), d_max=4096, device=dev)
        d, r = sim.simulate_chain(model, torch.as_tensor(theta, dtype=torch.float32, device=dev), noise)
        out.append((d.cpu(), r.cpu()))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


def test_discrete_normal_on_the_card_equals_the_cpu(device):
    from hygeia_tpu_torch.ops import discrete_normal as dn

    xs = torch.arange(-40, 50, dtype=torch.float64)
    for name in ("log_density", "grad_sd_log_density", "log_density_left_truncated",
                 "grad_var_log_density_truncated", "grad_mean_log_density_right_truncated"):
        f = getattr(dn, name)
        extra = (1,) if "left" in name else (6,) if "right" in name else (0, 8) if "truncated" in name else ()
        a = f(xs, *extra, 2.3, 1.7).numpy()
        b = f(xs.to(device), *extra, 2.3, 1.7).cpu().numpy()
        same = (a == b) | (np.isnan(a) & np.isnan(b))
        assert np.allclose(a[~same], b[~same], rtol=1e-12, atol=0), name


def _infer_dataset(root, T=120):
    """A T-site chromosome "c" and its theta file under ``root``; the
    keyword arguments of an infer_segment call of batch 0 over all of it
    (segment 100 + halo 20, M = 10)."""
    from hygeia_tpu_torch.utils import io as hio

    rng = np.random.default_rng(2)
    data, sg = root / "data", root / "sg"
    n = rng.poisson(20, size=(T, 2))
    hio.write_count_matrix(data / "positions_c.txt.gz", np.arange(1, T + 1) * 10)
    for g, p in (("control", 0.8), ("case", 0.3)):
        hio.write_count_matrix(data / f"n_total_reads_{g}_c.txt.gz", n)
        hio.write_count_matrix(data / f"n_methylated_reads_{g}_c.txt.gz", rng.binomial(n, p))
    hio.write_theta(sg / "theta_c.csv.gz", rng.normal(size=36))
    return dict(data_dir=str(data), single_group_dir=str(sg), chrom="c", segment_size=100,
                buffer_size=20, num_resampled_particles=(10,))


def test_infer_trace_on_the_card_holds_cuda_kernels(device, tmp_path):
    """infer_segment with trace_dir on the card: one Chrome trace with CUDA
    kernel events, K1's among them, and the runner's phases as host ranges;
    and the outputs of the untraced run."""
    import json

    from hygeia_tpu_torch.two_group.runner import infer_segment

    T = 120
    kw = dict(_infer_dataset(tmp_path, T), device=device)
    before = cr.KERNEL.launches
    a = infer_segment(results_dir=str(tmp_path / "traced"), trace_dir=str(tmp_path / "trace"), **kw)
    assert cr.KERNEL.launches - before == T - 1
    b = infer_segment(results_dir=str(tmp_path / "plain"), **kw)
    assert a == b
    (trace,) = (tmp_path / "trace").glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels and any("optimal_resampling" in e["name"] for e in kernels)
    assert {"infer.read", "infer.tables", "infer.write"} <= {e.get("name") for e in events}
    # The spans are host ranges: none is mirrored onto the device's timeline,
    # where a reading of the device's busy time would count it as work.
    assert not [e for e in events if e.get("cat") == "gpu_user_annotation"
                and e.get("name", "").startswith(("infer.", "site_loop."))]


@pytest.fixture(scope="module")
def recorded_card_call(tmp_path_factory):
    """One infer_segment call on the card with the recorder off, then the
    same call with it on: (output directories, spans and counters of the
    second)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from hygeia_tpu_torch.two_group.runner import infer_segment
    from hygeia_tpu_torch.utils import spans

    root = tmp_path_factory.mktemp("spans")
    kw = dict(_infer_dataset(root), device=torch.device("cuda", 0), seed=[0, 1])
    spans.drain()
    a = infer_segment(results_dir=str(root / "off"), **kw)
    spans.enable()
    try:
        b = infer_segment(results_dir=str(root / "on"), **kw)
    finally:
        spans.disable()
    got, counters = spans.drain()
    assert a == b
    return root / "off" / "chrom_c_0", root / "on" / "chrom_c_0", got, counters


def test_infer_call_on_the_card_captures_four_graphs(recorded_card_call):
    """The filter's and the backward pass's graphs of 8 sites and of one,
    each captured once in its own loop, with its nodes counted."""
    *_, got, _ = recorded_card_call
    by_id = {s.id: s for s in got}
    caps = [s for s in got if s.name == "site_loop.capture"]
    phase = lambda s: by_id[by_id[s.parent].parent].name  # capture < site_loop.run < infer.*
    assert sorted((phase(s), s.attrs["sites"]) for s in caps) == [
        ("infer.backward", 1), ("infer.backward", 8), ("infer.filter", 1), ("infer.filter", 8)]
    assert all(s.attrs["nodes"] > s.attrs["sites"] for s in caps)
    assert len([s for s in got if s.name == "site_loop.warm"]) == 2


def test_infer_call_on_the_card_counts_nodes_a_replayed_site(recorded_card_call):
    *_, got, counters = recorded_card_call
    # Each loop runs T - 1 = 119 sites, the first eagerly.
    assert counters["site_loop.sites_replayed"] == 2 * 118
    # A filter site is two draws, K1, K2 and the index's add (5 nodes), a
    # backward site a draw a unit and K3 (3 nodes at U = 2): ~4 a site over
    # both loops.
    assert 2 <= counters["site_loop.nodes_replayed"] / counters["site_loop.sites_replayed"] <= 10
    by_id = {s.id: s for s in got}
    caps = [s for s in got if s.name == "site_loop.capture"]
    assert {by_id[by_id[s.parent].parent].name for s in caps} == {"infer.filter", "infer.backward"}
    assert all(s.attrs["nodes"] <= 10 * s.attrs["sites"] for s in caps)


def test_infer_call_on_the_card_writes_the_same_files_with_the_recorder_on(recorded_card_call):
    import gzip
    import os

    off, on, _, _ = recorded_card_call
    files = sorted(os.listdir(off))
    assert files == sorted(os.listdir(on)) and any(f.endswith(".npz") for f in files)
    for name in files:
        if name.endswith(".npz"):
            a, b = np.load(off / name)["arr_0"], np.load(on / name)["arr_0"]
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        elif name.endswith(".gz"):  # the gzip header holds a time stamp
            assert gzip.decompress((off / name).read_bytes()) == gzip.decompress((on / name).read_bytes())
        elif not name.startswith("optimal_time"):
            assert (off / name).read_bytes() == (on / name).read_bytes(), name


@pytest.mark.parametrize("shape", [(8, 128), (1,), (1000,), (33, 257)])
def test_probe_kernel_equals_plain(device, shape):
    """The probe kernel (csrc/probe.cu) against 2 * x + x.max(), bit for
    bit, at .round4/pallas_smoke.py's (8, 128) and other sizes; a NaN makes
    every output NaN, as in the plain version."""
    from hygeia_tpu_torch.ops import probe as pr

    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy((rng.standard_normal(shape) * 100).astype(np.float32)).to(device)
    before = pr.PROBE.launches
    got = pr.probe(x)
    assert pr.PROBE.launches == before + 1
    assert torch.equal(got, pr.probe_plain(x))
    x.view(-1)[x.numel() // 2] = float("nan")
    torch.testing.assert_close(pr.probe(x), pr.probe_plain(x), rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("boundary", ["halo", "exchange"])
def test_meshed_inference_on_the_card(device, boundary):
    """sharded_two_group_inference on the card, mesh 4x2, R = 6, M = 50:
    K1 launched as expected_launches says (one chunk, and chunks of 3), logZ
    finite, and a second call equal to the first bit for bit."""
    from hygeia_tpu_torch.parallel import make_mesh, sharded_two_group_inference
    from hygeia_tpu_torch.parallel.sharded import expected_launches
    from hygeia_tpu_torch.two_group.model import make_params

    R = 6
    params = make_params(
        mu=(0.95, 0.05, 0.80, 0.20, 0.50, 0.50), sigma=(0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751),
        p_softmax_control=np.zeros((R, R)), omega_logit_control=np.full(R, 2.0), omega_case=0.8,
        kappa_control=np.full(R, 2.0), kappa_case=np.full(R, 2.0), merge_log_prob=np.log(0.1), split_prob=0.01,
        minimum_duration=3, d_max=201, device=device)
    rng = np.random.default_rng(3)
    n = rng.poisson(20, size=(200, 2)).astype(np.float32)
    y = np.minimum(rng.poisson(10, size=(200, 2)), n).astype(np.float32)
    kw = dict(segment_size=50, buffer_size=10, num_resampled_ancestors=50, num_samples_backward=25, seeds=[0, 1],
              boundary=boundary)
    outs = []
    for cap in (None, None, 3):
        tim = {}
        before = cr.KERNEL.launches
        outs.append(sharded_two_group_inference(make_mesh(4, 2, device=device), params, y, n, y, n,
                                                max_units_per_call=cap, timings=tim, **kw))
        chunks = len(tim["chunks"])
        reruns = 2 if boundary == "exchange" and cap else 0  # (0,0),(0,1),(1,0) | (1,1),(2,0),(2,1) | (3,*)
        assert cr.KERNEL.launches - before == expected_launches(boundary, 50, 10, 1, chunks, reruns)
        assert np.isfinite(outs[-1][1]).all()
    assert np.array_equal(outs[0][0], outs[1][0]) and np.array_equal(outs[0][1], outs[1][1])


# ---- the site loops as replayed CUDA graphs (ops/site_graphs.py) -------------

def _graph_params(device, T):
    from hygeia_tpu_torch.two_group.model import make_params

    R = 6
    return make_params(
        mu=[0.95, 0.05, 0.80, 0.20, 0.50, 0.50], sigma=[0.05, 0.05, 0.1, 0.1, 0.1, 0.2886751],
        p_softmax_control=np.zeros((R, R)), omega_logit_control=np.full(R, 4.0), omega_case=0.8,
        kappa_control=np.full(R, 2.0), kappa_case=np.full(R, 2.0), merge_log_prob=np.log(0.1),
        split_prob=0.01, minimum_duration=3, d_max=T + 1, device=device,
    )


def _graph_tables(params, T, U, seed):
    from hygeia_tpu_torch.ops.emissions import emission_log_prob_table

    rng = np.random.default_rng(seed)
    n = rng.poisson(20, size=(U, T, 2))
    tab = lambda p: torch.stack([
        emission_log_prob_table(rng.binomial(n[u], p), n[u], params.alpha, params.beta) for u in range(U)
    ])
    return tab(0.7), tab(0.3)


@pytest.mark.parametrize("K", [1, 3, 8])
def test_graphed_filter_and_backward_equal_eager(device, K):
    """T = 206 at M = 50 (N = 2400), U = 3 units with per-unit generators
    and per-unit segments, warm for two units (use_init): run_filter and
    both backward forms (K3 a site) replayed as graphs of K sites equal
    their eager runs (sites_per_graph=0) bit for bit; K1's and K3's counts
    count the replays."""
    from hygeia_tpu_torch.two_group.backward import backward_simulation, backward_simulation_conditioned
    from hygeia_tpu_torch.two_group.filter import run_filter

    T, U, M, B = 206, 3, 50, 25
    params = _graph_params(device, T)
    E_c, E_k = _graph_tables(params, T, U, seed=K)
    gens = lambda base: [torch.Generator(device=device).manual_seed(base + u) for u in range(U)]
    prev = run_filter(params, E_c, E_k, M, n_units=U, generator=gens(40), return_history=False)
    init = (prev.log_weights, torch.stack(prev.particles, 1))
    out = {}
    for k in (0, K):
        before = cr.KERNEL.launches
        res = run_filter(params, E_c, E_k, M, n_units=U, generator=gens(7), init_state=init,
                         use_init=[True, False, True], sites_per_graph=k)
        assert cr.KERNEL.launches - before == T - 1 + 1  # the warm step, then sites 1..T-1
        before = k3.KERNEL.launches
        traj = backward_simulation(params, res.log_weights, res.particles, B, generator=gens(11), sites_per_graph=k)
        assert k3.KERNEL.launches - before == T - 1  # one a backward site
        cond = backward_simulation_conditioned(params, res.log_weights, res.particles, traj[:, 0],
                                               torch.tensor([True, False, True], device=device),
                                               generator=gens(13), sites_per_graph=k)
        assert k3.KERNEL.launches - before == 2 * (T - 1) + 1  # and the conditioned terminal draw
        out[k] = [res.log_weights, *res.particles, res.log_normalizing_constant, res.shifts,
                  res.degenerate_steps, traj, cond]
    for a, b in zip(out[0], out[K]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K", [1, 3, 8])
def test_graphed_engine_equals_eager(device, K, monkeypatch):
    """The single-group engine at the CLI's width (N = 250) with updates
    every 50 sites, over 600 sites, for 3 units with t_limit (600, 333,
    517): the steady, update and past-the-limit sites replayed as graphs
    (K sites, one site at an update) equal the eager run bit for bit, and
    K1's count is T - 1 either way."""
    from hygeia_tpu_torch.ops import site_graphs
    from hygeia_tpu_torch.ops.emissions import emission_log_prob_table
    from hygeia_tpu_torch.single_group.engine import EngineConfig, run_online_combined_inference
    from hygeia_tpu_torch.single_group.model import make_model, parameters_to_theta

    R, T = 6, 600
    rng = np.random.default_rng(K)
    model = make_model([0.99, 0.01, 0.8, 0.2, 0.5, 0.5], [0.05, 0.05, 0.2, 0.2, 0.2, 0.2886751],
                       2, np.full(R, 2.0), device=device)
    p = np.full((R, R), 1.0 / (R - 1))
    np.fill_diagonal(p, 0.0)
    theta = parameters_to_theta(p, [0.995, 0.975, 0.95, 0.925, 0.9, 0.9])
    n = rng.poisson(20, size=(3, T, 2))
    y = rng.binomial(n, np.repeat(rng.uniform(0, 1, T // 50), 50)[None, :, None])
    E = torch.stack([emission_log_prob_table(y[u], n[u], model.alpha, model.beta) for u in range(3)])
    cfg = EngineConfig(estimate_parameters=True, steps_per_update=50)
    captured = []
    graph = site_graphs.SiteLoop._graph

    def record(loop, step, kind, sites):
        captured.append((kind, sites))
        return graph(loop, step, kind, sites)

    monkeypatch.setattr(site_graphs.SiteLoop, "_graph", record)
    out = {}
    for k in (0, K):
        before = cr.KERNEL.launches
        res = run_online_combined_inference(model, theta, E, cfg, n_units=3, shared_draws=True,
                                            generator=torch.Generator(device=device).manual_seed(0),
                                            t_limit=[600, 333, 517], sites_per_graph=k)
        assert cr.KERNEL.launches - before == T - 1
        out[k] = res
    assert {("update", 1), ("frozen update", 1)} <= set(captured)
    for name, a, b in zip(out[0]._fields, out[0], out[K]):
        for x, y in zip(a, b) if isinstance(a, tuple) else [(a, b)]:
            assert torch.equal(x, y), name


@pytest.mark.parametrize("K", [1, 3, 8])
def test_graphed_marginal_filter_equals_eager(device, K):
    """run_marginal_filter at M = 50 (N = 2400), U = 2 units on one
    generator, T = 206, a window of 8 pending times that spills: replayed
    as graphs of K sites it equals the eager run (sites_per_graph=0) bit
    for bit, and K1's count is T - 1 either way."""
    from hygeia_tpu_torch.two_group.marginal import run_marginal_filter

    T, U, M = 206, 2, 50
    params = _graph_params(device, T)
    E_c, E_k = _graph_tables(params, T, U, seed=K + 20)
    out = {}
    for k in (0, K):
        before = cr.KERNEL.launches
        out[k] = run_marginal_filter(params, E_c, E_k, M, n_units=U, smoothing_window=8, sites_per_graph=k,
                                     generator=torch.Generator(device=device).manual_seed(3))
        assert cr.KERNEL.launches - before == T - 1
    assert int(out[0].spill_count.sum()) > 0
    for name, a, b in zip(out[0]._fields, out[0], out[K]):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("K", [1, 3, 8])
def test_graphed_simulator_chains_equal_eager(device, K):
    """Both simulators' chains (two-group, 600 sites; single-group at the
    verb's model, 800 sites) replayed as graphs of K sites equal their
    eager runs bit for bit."""
    from hygeia_tpu_torch.single_group import simulate as sg_sim
    from hygeia_tpu_torch.single_group.model import make_model, parameters_to_theta
    from hygeia_tpu_torch.single_group.runner import DEFAULT_MU, DEFAULT_OMEGA, DEFAULT_SIGMA, default_p
    from hygeia_tpu_torch.two_group import simulate as tg_sim

    R, T = 6, 600
    params = _graph_params(device, T)
    noise = tg_sim.draw_chain_noise(T, R, generator=torch.Generator(device=device).manual_seed(K), device=device)
    states = [tg_sim.simulate_chain(params, noise, sites_per_graph=k) for k in (0, K)]
    assert torch.equal(states[0], states[1])

    T = 800
    noise = sg_sim.draw_chain_noise(T, R, generator=torch.Generator(device=device).manual_seed(K), device=device)
    theta = parameters_to_theta(default_p(R), np.asarray(DEFAULT_OMEGA), np.full(R, 2.0))
    model = make_model(np.asarray(DEFAULT_MU), DEFAULT_SIGMA, 2, np.full(R, 2.0), d_max=4096, device=device)
    theta = torch.as_tensor(theta, dtype=torch.float32, device=device)
    (d0, r0), (d1, r1) = (sg_sim.simulate_chain(model, theta, noise, sites_per_graph=k) for k in (0, K))
    assert torch.equal(d0, d1) and torch.equal(r0, r1)


def test_streamed_graphed_equals_eager_monolithic(device):
    """Streamed INFER, whose blocks restore saved generator states between
    graphed runs, against the monolithic filter and backward pass run
    eagerly: the trajectories and logZ bit for bit."""
    from hygeia_tpu_torch.two_group.backward import backward_simulation
    from hygeia_tpu_torch.two_group.filter import run_filter
    from hygeia_tpu_torch.two_group.streaming import launches_per_call, streamed_inference

    T, U, M, B, W = 300, 2, 50, 25, 64
    params = _graph_params(device, T)
    E_c, E_k = (e[0] for e in _graph_tables(params, T, 1, seed=5))
    gen = lambda s: torch.Generator(device=device).manual_seed(s)
    res = run_filter(params, E_c, E_k, M, n_units=U, generator=gen(1), sites_per_graph=0)
    traj = backward_simulation(params, res.log_weights, res.particles, B, generator=gen(2), sites_per_graph=0)
    before = cr.KERNEL.launches
    got, log_z, degen = streamed_inference(params, E_c, E_k, M, B, n_units=U, generator=gen(1),
                                           backward_generator=gen(2), block_size=W)
    assert cr.KERNEL.launches - before == launches_per_call(T, W)
    np.testing.assert_array_equal(got, traj.cpu().numpy())
    assert torch.equal(log_z, res.log_normalizing_constant)
    assert torch.equal(degen, res.degenerate_steps)


def test_a_step_that_waits_for_the_host_fails_its_capture(device):
    """A step that synchronises (``.item()``) cannot be captured: the loop
    raises, and the eager route is not taken instead."""
    from hygeia_tpu_torch.ops.site_graphs import SiteLoop

    x = torch.zeros((4,), device=device)
    calls = []

    def step():
        calls.append(1)
        x.add_(1.0)
        x.sum().item()

    with pytest.raises(RuntimeError):
        with SiteLoop(device, 4) as loop:
            loop.run(step, 9)
    torch.cuda.synchronize(device)
    assert len(calls) == 2  # the eager first site, then the capture that failed
    assert torch.equal(x, torch.ones((4,), device=device))  # only the eager site ran
