"""The port on the card: the optimal-resampler kernel against its plain
PyTorch version on the same tensors and uniforms, the single-group hazard
tables against the CPU's, and the paths that go through the kernel.

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
order).
"""

import numpy as np
import pytest
import torch

from hygeia_tpu_torch.ops import resampling as plain
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
    before = cr.KERNEL.launches
    res = run_filter(params, E, E, M, n_units=3, generator=torch.Generator(device=device).manual_seed(0))
    assert cr.KERNEL.launches - before == T - 1
    assert bool(torch.isfinite(res.log_normalizing_constant).all())
    assert int(res.degenerate_steps.sum()) == 0


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
