"""K3, one site of the two-group backward simulation, as a hand-written
CUDA kernel.

The kernel is ``hygeia_tpu_torch/csrc/backward_step.cu``: one thread block
per (unit, trajectory row), so one launch draws every row of every unit
of a site. From history row t, the carry of next states and the site's
uniforms it forms each row's backward-kernel logits, adds the Gumbel noise
of the uniforms, takes the argmax, writes the chosen particles' states
into row t of the trajectories and into the carry, and counts the site
index down. Its plain version is two_group/backward.py's ``_plain_site``
(``_backward_logits`` with ``history_layout=True``, the Gumbel transform
and ``_categorical_rows``); two_group/backward.py::backward_site
dispatches between the two on the device of its tensors.

``backward_step_cuda`` takes f32 weights and uniforms and the history
dtypes of ops/cuda_filter_step.py, and raises on anything else; there is
no fallback to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from hygeia_tpu_torch.ops.build import SMEM_BUDGET, Kernel, check_tensor
from hygeia_tpu_torch.ops.cuda_filter_step import HISTORY_DTYPES


def smem_bytes(m, r):
    """Dynamic shared memory of one block, as the kernel lays it out: three
    hazard logs of each of the M ancestors, two duration-1 hazard logs and
    a control transition of each of the R regimes, and the (2, 2) merged
    table."""
    return 4 * (3 * m + 3 * r + 4)


def supports(n, b, r):
    """None when the kernel takes history rows of N particles, B
    trajectories a unit and R regimes, else the bound that refuses them.
    Needs no card."""
    if b < 1 or r < 1:
        return f"the CUDA backward step needs B >= 1 and R >= 1, got B={b}, R={r}"
    if r > 127:
        return f"the CUDA backward step reads int8 regimes: R must be <= 127, got R={r}"
    i = 2 * r + r * r  # children an ancestor: two_group/proposal.py::num_children
    if n < i or n % i:
        return f"the CUDA backward step needs the history layout N = M * (2R + R^2) = M * {i}, got N={n}"
    m = n // i
    if smem_bytes(m, r) > SMEM_BUDGET:
        return (
            f"the CUDA backward step stages a row's ancestors in shared memory: N={n}, R={r} (M={m}) needs "
            f"{smem_bytes(m, r)} bytes, more than the {SMEM_BUDGET} an H100 block may opt in to"
        )
    return None


class _Args(ctypes.Structure):
    """The kernel's BackwardStepArgs, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "idx", "h_lw", "h_m", "h_dc", "h_rc", "h_dk", "h_rk", "uniforms", "rho_both", "log_p_control",
        "log_p_merged", "nxt", "traj")] + [
        ("T", ctypes.c_int64)] + [
        (name, ctypes.c_int) for name in ("U", "B", "N", "M", "R", "W", "min_duration")]


KERNEL = Kernel("backward_step", args=_Args)


def check_inputs(idx, hist, uniforms, nxt, traj, rho_both, log_p_control, log_p_merged):
    """The launch's shapes, as ``backward_step_cuda`` takes its arguments:
    (U, T, B, N, M, R, W); raises ValueError or TypeError naming the first
    argument the kernel cannot take. Every tensor must be on the history's
    device; the device's type is not checked here, so this runs on the
    CPU."""
    if len(hist) != 6 or hist[0].dim() != 3:
        raise ValueError("hist must be six (U, T, N) tensors: the weights and the five fields")
    dev = hist[0].device
    U, T, N = hist[0].shape
    if uniforms.dim() != 3:
        raise ValueError(f"uniforms must be ({U}, B, {N}), got {tuple(uniforms.shape)}")
    B = int(uniforms.shape[1])
    if log_p_control.dim() != 2:
        raise ValueError(f"log_p_control must be (R, R), got {tuple(log_p_control.shape)}")
    R = int(log_p_control.shape[0])
    refused = supports(N, B, R)
    if refused:
        raise ValueError(refused)
    if U * B > 2**31 - 1:
        raise ValueError(f"the CUDA backward step launches a block a row: U * B = {U * B} is more than 2**31 - 1")
    f32 = torch.float32
    for k, (x, dt) in enumerate(zip(hist, HISTORY_DTYPES)):
        check_tensor(f"hist[{k}]", x, (U, T, N), dt, dev)
    check_tensor("uniforms", uniforms, (U, B, N), f32, dev)
    check_tensor("idx", idx, (2,), torch.int64, dev)
    check_tensor("nxt", nxt, (U, B, 5), torch.int32, dev)
    check_tensor("traj", traj, (U, T, B, 5), torch.int32, dev)
    if rho_both.dim() != 3:
        raise ValueError(f"rho_both must be (2, R, W), got {tuple(rho_both.shape)}")
    W = int(rho_both.shape[2])
    check_tensor("rho_both", rho_both, (2, R, W), f32, dev)
    check_tensor("log_p_control", log_p_control, (R, R), f32, dev)
    check_tensor("log_p_merged", log_p_merged, (2, 2), f32, dev)
    return U, T, B, N, N // (2 * R + R * R), R, W


def backward_step_cuda(idx, hist, uniforms, nxt, traj, rho_both, log_p_control, log_p_merged, min_duration):
    """Launch K3 on the current stream for site t = idx[0]; no
    synchronisation.

    idx (2,) int64: (t, 0), the 0 a count the launch uses and leaves at 0;
    the launch leaves t - 1 in idx[0]. hist: the filter history's six
    (U, T, N) tensors (HISTORY_DTYPES: the weights, then m, d_c, r_c, d_k,
    r_k); uniforms (U, B, N) f32, the site's; nxt (U, B, 5) int32, the
    states at t + 1, overwritten with the states drawn at t, which also go
    to row t of traj (U, T, B, 5) int32; rho_both (2, R, W),
    log_p_control (R, R), log_p_merged (2, 2) f32. Raises where the
    kernel cannot go (``check_inputs``)."""
    dev = hist[0].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA backward step needs CUDA tensors, got {dev}")
    U, T, B, N, M, R, W = check_inputs(idx, hist, uniforms, nxt, traj, rho_both, log_p_control, log_p_merged)
    lib = KERNEL.load()
    args = _Args(
        idx.data_ptr(), *(x.data_ptr() for x in hist), uniforms.data_ptr(), rho_both.data_ptr(),
        log_p_control.data_ptr(), log_p_merged.data_ptr(), nxt.data_ptr(), traj.data_ptr(), T,
        U, B, N, M, R, W, int(min_duration),
    )
    with torch.cuda.device(dev):
        rc = lib.hygeia_backward_step(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        KERNEL.failed(rc)
    KERNEL.count()
