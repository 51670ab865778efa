"""The optimal finite-state resampler as a hand-written CUDA kernel.

Counterpart of hygeia_tpu/ops/pallas_resampling.py. The kernel is
``hygeia_tpu_torch/csrc/optimal_resampling.cu``: one thread block per unit,
so one launch resamples every unit of a site. Its plain version is
ops/resampling.py::optimal_finite_state_resampling.

``optimal_resampling`` dispatches on the tensor's device and on nothing
else: a CPU tensor goes to the plain version; a CUDA tensor goes to the
kernel, or the call raises. There is no fallback from the kernel to the
plain version.
"""

from __future__ import annotations

import ctypes

import torch

from hygeia_tpu_torch.ops import resampling as plain
from hygeia_tpu_torch.ops.resampling import ResampleResult

MAX_SLOTS = 1024  # kMaxSlots in the kernel: M + 1 must fit
MAX_SORT_KEYS = 2048  # kMaxSortKeys: the top-(M+1) is a sort up to here
# The dynamic shared memory a block may opt in to on an H100 (sm_90:
# 227 KB, cudaDevAttrMaxSharedMemoryPerBlockOptin), less 1 KB for the
# kernel's static shared arrays (~170 B).
SMEM_BUDGET = 227 * 1024 - 1024


def _sort_keys(n):
    """Padded key count of the kernel's sort path (0: the argmax path)."""
    p = 2
    while p < n:
        p *= 2
    return p if p <= MAX_SORT_KEYS else 0


def smem_bytes(n, m):
    """Dynamic shared memory of one block, as the kernel lays it out: N
    weights, N prefix sums and N flag bytes; three (M+1)-slot arrays; the
    sort path's padded (value, index) keys."""
    kk = min(m + 1, n)
    return 9 * n + 12 * kk + 8 * _sort_keys(n)


def supports(n, m):
    """None when the kernel takes N weights and M offspring, else the bound
    that refuses them. Needs no card."""
    if m < 1 or m + 1 > MAX_SLOTS:
        return f"the CUDA resampler needs 1 <= M and M + 1 <= {MAX_SLOTS}, got M={m}"
    if n < 1:
        return f"the CUDA resampler needs N >= 1, got N={n}"
    if smem_bytes(n, m) > SMEM_BUDGET:
        return (
            f"the CUDA resampler keeps a unit in shared memory: N={n}, M={m} needs "
            f"{smem_bytes(n, m)} bytes, more than the {SMEM_BUDGET} an H100 block may opt in to"
        )
    return None


class _Kernel:
    """The loaded library and the launch count. ``launches`` goes up by one
    per kernel launch and nowhere else."""

    def __init__(self):
        self.lib = None
        self.build = None
        self.launches = 0

    def load(self):
        if self.lib is None:
            from hygeia_tpu_torch.ops.build import load_library

            lib, info = load_library()
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.hygeia_optimal_resampling.argtypes = [vp, vp, vp, i, i, i, vp, vp, vp, vp, vp, vp]
            lib.hygeia_optimal_resampling.restype = i
            lib.hygeia_cuda_error_string.argtypes = [i]
            lib.hygeia_cuda_error_string.restype = ctypes.c_char_p
            self.lib, self.build = lib, info
        return self.lib


KERNEL = _Kernel()


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def optimal_resampling_cuda(log_weights, num_offspring, u_sys, u_mult) -> ResampleResult:
    """Launch the CUDA kernel on the current stream; no synchronisation.

    log_weights (U, N) f32, each row normalised (logsumexp 0) and NaN-free;
    u_sys (U,) f32; u_mult (U, M) f32. Raises where the kernel cannot go
    (``supports``)."""
    if log_weights.device.type != "cuda":
        raise ValueError(
            f"the CUDA resampler needs CUDA tensors, got {log_weights.device}"
        )
    if log_weights.dim() != 2:
        raise ValueError(f"log_weights must be (U, N), got {tuple(log_weights.shape)}")
    U, N = log_weights.shape
    M = int(num_offspring)
    dev = log_weights.device
    refused = supports(N, M)
    if refused:
        raise ValueError(refused)
    _check("log_weights", log_weights, (U, N), torch.float32, dev)
    _check("u_sys", u_sys, (U,), torch.float32, dev)
    _check("u_mult", u_mult, (U, M), torch.float32, dev)

    lib = KERNEL.load()
    parents = torch.empty((U, M), dtype=torch.int32, device=dev)
    new_w = torch.empty((U, M), dtype=torch.float32, device=dev)
    top_idx = torch.empty((U, M), dtype=torch.int32, device=dev)
    log_c = torch.empty((U,), dtype=torch.float32, device=dev)
    bad = torch.empty((U,), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.hygeia_optimal_resampling(
            log_weights.data_ptr(), u_sys.data_ptr(), u_mult.data_ptr(),
            U, N, M,
            parents.data_ptr(), new_w.data_ptr(), top_idx.data_ptr(),
            log_c.data_ptr(), bad.data_ptr(), stream,
        )
    if rc != 0:
        msg = lib.hygeia_cuda_error_string(rc).decode()
        raise RuntimeError(f"optimal_resampling kernel launch failed: {msg} ({rc})")
    KERNEL.launches += 1
    return ResampleResult(
        parent_indices=parents,
        log_c=log_c,
        use_unbiased=bad,
        new_log_weights=new_w,
        top_m_indices=top_idx,
    )


def optimal_resampling(log_weights, num_offspring, u_sys, u_mult) -> ResampleResult:
    """Optimal finite-state resampling: the plain version for CPU tensors,
    the CUDA kernel for everything else (which raises off CUDA)."""
    if log_weights.device.type == "cpu":
        return plain.optimal_finite_state_resampling(log_weights, num_offspring, u_sys, u_mult)
    return optimal_resampling_cuda(log_weights, num_offspring, u_sys, u_mult)
