"""The toolchain probe, 2*x + max(x), as a hand-written CUDA kernel.

Counterpart of .round4/pallas_smoke.py (``f``, body ``kernel``): the TPU
round's check that a Pallas kernel compiles and launches, on one (8, 128)
f32 block. The kernel is ``hygeia_tpu_torch/csrc/probe.cu``, one thread
block; its plain version is ``probe_plain``, ``2 * x + x.max()``, which it
equals bit for bit (2*x is exact, so both round the one sum).

``probe`` dispatches on the tensor's device alone: the plain version for a
CPU tensor, the kernel for a CUDA one (or it raises). No path of the
pipeline runs it; ``chip_smoke.py`` launches it to check the build and
launch route of the port's kernels.
"""

from __future__ import annotations

import ctypes

import torch

from hygeia_tpu_torch.ops.build import Kernel


def _declare(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.hygeia_probe.argtypes = [vp, vp, i, vp]
    lib.hygeia_probe.restype = i
    return lib.hygeia_probe


# No site loop runs the probe: it counts its launches, and is not one of
# build.KERNELS.
PROBE = Kernel("probe", _declare, counted=False)


def probe_plain(x):
    """2 * x + x.max(), the kernel's plain version."""
    return 2 * x + x.max()


def probe_cuda(x):
    """Launch the kernel on the current stream for a contiguous f32 CUDA
    tensor; no synchronisation."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA probe needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() < 1 or x.numel() >= 2**31:
        raise ValueError(f"the probe takes a non-empty contiguous f32 tensor, got {x.dtype} {tuple(x.shape)}")
    lib = PROBE.load()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.hygeia_probe(x.data_ptr(), out.data_ptr(), x.numel(),
                              torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        PROBE.failed(rc)
    PROBE.count()
    return out


def probe(x):
    """2*x + max(x): the plain version for a CPU tensor, the kernel for
    everything else (which raises off CUDA)."""
    if x.device.type == "cpu":
        return probe_plain(x)
    return probe_cuda(x)
