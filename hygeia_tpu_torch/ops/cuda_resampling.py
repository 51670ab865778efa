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
MIN_THREADS = 256  # kMinThreads: a block for N <= 256
WIDE_THREADS = 512  # kWideThreads: a block for N > 256
RADIX_BINS, RADIX_PASSES = 256, 6  # the select's histograms, one a pass
# The dynamic shared memory a block may opt in to on an H100 (sm_90:
# 227 KB, cudaDevAttrMaxSharedMemoryPerBlockOptin), less 1 KB for the
# kernel's static shared arrays (~200 B).
SMEM_BUDGET = 227 * 1024 - 1024


def threads(n, m):
    """Threads of a block: 256 for N <= 256, 512 above, or the next power
    of two >= M + 1 when that is larger (the kernel's sort holds one 8-byte
    key a thread)."""
    p = 1
    while p < m + 1:
        p *= 2
    return max(p, MIN_THREADS if n <= MIN_THREADS else WIDE_THREADS)


def smem_bytes(n, m):
    """Dynamic shared memory of one block, as the kernel lays it out: a
    scratch region (the select's histograms and two exchange buffers of
    one key a thread; later the N prefix sums), padded to 16 bytes; N
    weights; three (M+1)-slot arrays."""
    scratch = max(4 * n, 4 * RADIX_BINS * RADIX_PASSES + 2 * 8 * threads(n, m))
    return -(-scratch // 16) * 16 + 4 * n + 12 * (m + 1)


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
        self.launch = None  # the C entry, argtypes set
        self.launches = 0

    def load(self):
        if self.lib is None:
            from hygeia_tpu_torch.ops.build import load_library

            lib, info = load_library()
            vp, i = ctypes.c_void_p, ctypes.c_int
            lib.hygeia_optimal_resampling.argtypes = [vp, vp, vp, i, i, i, vp, vp, vp, vp, vp, vp]
            lib.hygeia_optimal_resampling.restype = i
            lib.hygeia_empty_launch.argtypes = [vp]
            lib.hygeia_empty_launch.restype = i
            lib.hygeia_cuda_error_string.argtypes = [i]
            lib.hygeia_cuda_error_string.restype = ctypes.c_char_p
            self.lib, self.build, self.launch = lib, info, lib.hygeia_optimal_resampling
        return self.lib


KERNEL = _Kernel()
# The (N, M) that ``supports`` has taken: a hit needs no second verdict.
_TAKEN = set()


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
    (``supports``).

    This runs once per site of a host-bound loop, so it spends as little
    host time as it can: the shape's verdict is remembered, the checks are
    one expression until one fails, the stream comes from the raw lookup,
    the outputs are ``empty_like`` of the checked inputs, and the device
    context is entered only off the current device. (One allocation viewed
    as the five outputs was measured no cheaper than five allocations: a
    split and five views cost what four small allocations do.)"""
    dev = log_weights.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA resampler needs CUDA tensors, got {dev}")
    if log_weights.dim() != 2:
        raise ValueError(f"log_weights must be (U, N), got {tuple(log_weights.shape)}")
    U, N = log_weights.shape
    M = int(num_offspring)
    if (N, M) not in _TAKEN:
        refused = supports(N, M)
        if refused:
            raise ValueError(refused)
        _TAKEN.add((N, M))
    f32 = torch.float32
    if not (
        log_weights.dtype is f32 and log_weights.is_contiguous()
        and u_sys.dtype is f32 and u_sys.device == dev and u_sys.shape == (U,) and u_sys.is_contiguous()
        and u_mult.dtype is f32 and u_mult.device == dev and u_mult.shape == (U, M)
        and u_mult.is_contiguous()
    ):  # one of these names what is wrong
        _check("log_weights", log_weights, (U, N), f32, dev)
        _check("u_sys", u_sys, (U,), f32, dev)
        _check("u_mult", u_mult, (U, M), f32, dev)

    launch = KERNEL.launch or KERNEL.load().hygeia_optimal_resampling
    # empty_like of a checked input: about half the host time of
    # torch.empty(shape, dtype=..., device=...).
    parents = torch.empty_like(u_mult, dtype=torch.int32)
    new_w = torch.empty_like(u_mult)
    top_idx = torch.empty_like(u_mult, dtype=torch.int32)
    log_c = torch.empty_like(u_sys)
    bad = torch.empty_like(u_sys, dtype=torch.bool)
    args = (
        log_weights.data_ptr(), u_sys.data_ptr(), u_mult.data_ptr(), U, N, M,
        parents.data_ptr(), new_w.data_ptr(), top_idx.data_ptr(), log_c.data_ptr(), bad.data_ptr(),
    )
    # torch._C._cuda_getCurrentRawStream is what torch.cuda.current_stream
    # wraps: the same handle as torch.cuda.current_stream(dev).cuda_stream,
    # which is the public call to return to should the private one go.
    index = dev.index
    if index == torch.cuda.current_device():
        rc = launch(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(dev):
            rc = launch(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        msg = KERNEL.lib.hygeia_cuda_error_string(rc).decode()
        raise RuntimeError(f"optimal_resampling kernel launch failed: {msg} ({rc})")
    KERNEL.launches += 1
    return ResampleResult(parents, log_c, bad, new_w, top_idx)


def optimal_resampling(log_weights, num_offspring, u_sys, u_mult) -> ResampleResult:
    """Optimal finite-state resampling: the plain version for CPU tensors,
    the CUDA kernel for everything else (which raises off CUDA)."""
    if log_weights.device.type == "cpu":
        return plain.optimal_finite_state_resampling(log_weights, num_offspring, u_sys, u_mult)
    return optimal_resampling_cuda(log_weights, num_offspring, u_sys, u_mult)
