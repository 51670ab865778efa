"""The port's CUDA kernel on the card: the optimal resampler against its
plain PyTorch version on the same tensors and uniforms.

Marked ``cuda``; skipped where there is no CUDA device. On the machine with
the GPU (no JAX there, so without the repo's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: parents, top-M indices and fallback flags equal; log_c and the
new weights rtol 1e-5 (f32 sums taken in another order).
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


@pytest.mark.parametrize("U,N,M", [(32, 2400, 50), (1, 2400, 50), (3, 240, 5), (5, 1000, 127), (2, 100, 127), (1, 2400, 1)])
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


def test_kernel_counts_launches_and_rejects_what_it_cannot_take(device):
    lw = _weights(np.random.default_rng(0), 2, 240, 1.0, device)
    us, um = torch.rand(2, device=device), torch.rand(2, 5, device=device)
    before = cr.KERNEL.launches
    cr.optimal_resampling(lw, 5, us, um)
    assert cr.KERNEL.launches == before + 1
    with pytest.raises(ValueError, match="M \\+ 1"):
        cr.optimal_resampling(lw, 128, us, torch.rand(2, 128, device=device))
    with pytest.raises(TypeError):
        cr.optimal_resampling(lw.double(), 5, us, um)
    big = torch.zeros((1, cr.MAX_N + 1), device=device)
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
