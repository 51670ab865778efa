"""K2, the two-group filter's site step after the resampler, as a
hand-written CUDA kernel.

The kernel is ``hygeia_tpu_torch/csrc/filter_step.cu``: one thread block
per unit, so one launch steps every unit of a site. From K1's outputs
(ops/cuda_resampling.py) it picks the ancestors, expands and scores their
children, updates and renormalises the weights, and writes the carry, the
history row and the site's shift and degenerate flag. Its plain version
is two_group/filter.py's ``_expand_and_weigh`` + ``_renormalise`` and
``_site_step``'s writes; two_group/filter.py::filter_site dispatches
between the two on the device of its tensors.

``filter_step_cuda`` takes f32 weights and tables and the history dtypes
of two_group/filter.py, and raises on anything else; there is no fallback
to the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from hygeia_tpu_torch.ops import cuda_resampling  # noqa: F401  (K1 joins build.KERNELS before K2)
from hygeia_tpu_torch.ops.build import SMEM_BUDGET, Kernel, check_tensor

ANC_FLOATS, ANC_INTS = 14, 7  # kAncF, kAncI: what the kernel stages an ancestor
# The history's dtypes: the weights, then (m, d_c, r_c, d_k, r_k).
HISTORY_DTYPES = (torch.float32, torch.int8, torch.int32, torch.int8, torch.int32, torch.int8)


def smem_bytes(n, m, r):
    """Dynamic shared memory of one block, as the kernel lays it out: N new
    weights, the (R, R) control transition table, the site's two emission
    rows and the staged ancestors."""
    return 4 * (n + r * r + 2 * r + ANC_FLOATS * m) + 4 * ANC_INTS * m


def supports(n, m, r):
    """None when the kernel takes N particles from M ancestors of R regimes,
    else the bound that refuses them. Needs no card."""
    if m < 1 or r < 1:
        return f"the CUDA filter step needs M >= 1 and R >= 1, got M={m}, R={r}"
    if r > 127:
        return f"the CUDA filter step writes int8 regimes: R must be <= 127, got R={r}"
    if n != m * (2 * r + r * r):
        return f"the CUDA filter step needs N = M * (2R + R^2) = {m * (2 * r + r * r)}, got N={n}"
    if smem_bytes(n, m, r) > SMEM_BUDGET:
        return (
            f"the CUDA filter step keeps a unit in shared memory: N={n}, M={m}, R={r} needs "
            f"{smem_bytes(n, m, r)} bytes, more than the {SMEM_BUDGET} an H100 block may opt in to"
        )
    return None


class _Args(ctypes.Structure):
    """The kernel's FilterStepArgs, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "idx", "prev_lw", "prev_parts", "k1_parents", "k1_top", "k1_log_c", "k1_unbiased", "e_c", "e_k")] + [
        (name, ctypes.c_int64) for name in ("ec_su", "ec_st", "ek_su", "ek_st")] + [
        (name, ctypes.c_void_p) for name in (
            "rho_both", "log_p_control", "log_p_merged", "out_lw", "out_parts", "shifts", "degen")] + [
        ("s_ld", ctypes.c_int64)] + [
        (name, ctypes.c_void_p) for name in ("h_lw", "h_m", "h_dc", "h_rc", "h_dk", "h_rk")] + [
        ("h_T", ctypes.c_int64), ("parents_out", ctypes.c_void_p)] + [
        (name, ctypes.c_int) for name in ("U", "N", "M", "R", "W", "min_duration")] + [
        ("neg_log_m", ctypes.c_float), ("neg_log_n", ctypes.c_float)]


KERNEL = Kernel("filter_step", args=_Args)


def _emission_strides(name, e, U, R, device):
    """(unit stride, site stride) of a (T, R) or (U, T, R) f32 table whose
    rows are contiguous; a (T, R) table is shared by the units (stride 0)."""
    if e.device != device:
        raise ValueError(f"{name} is on {e.device}, expected {device}")
    if e.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {e.dtype}, expected torch.float32")
    if e.dim() not in (2, 3) or e.shape[-1] != R or (e.dim() == 3 and e.shape[0] != U):
        raise ValueError(f"{name} must be (T, {R}) or ({U}, T, {R}), got {tuple(e.shape)}")
    if e.stride(-1) != 1:
        raise ValueError(f"{name}'s regime axis must be contiguous, got strides {e.stride()}")
    return (e.stride(0) if e.dim() == 3 else 0), e.stride(-2)


def check_inputs(emission_control, emission_case, idx, prev_lw, prev_parts, resampled, M, rho_both,
                 log_p_control, log_p_merged, out_lw, out_parts, shifts, degen, hist=None, parents=None):
    """The launch's shapes, as ``filter_step_cuda`` takes its arguments:
    (U, N, R, W, emission strides (control unit, site, case unit, site),
    the history's sites); raises ValueError or TypeError naming the first
    argument the kernel cannot take. Every tensor must be on prev_lw's
    device; the device's type is not checked here, so this runs on the
    CPU."""
    dev = prev_lw.device
    if prev_lw.dim() != 2:
        raise ValueError(f"prev_lw must be (U, N), got {tuple(prev_lw.shape)}")
    U, N = prev_lw.shape
    M = int(M)
    R = int(log_p_control.shape[0])
    refused = supports(N, M, R)
    if refused:
        raise ValueError(refused)
    f32, i32 = torch.float32, torch.int32
    check_tensor("prev_lw", prev_lw, (U, N), f32, dev)
    check_tensor("prev_parts", prev_parts, (U, 5, N), i32, dev)
    check_tensor("parent_indices", resampled.parent_indices, (U, M), i32, dev)
    check_tensor("top_m_indices", resampled.top_m_indices, (U, M), i32, dev)
    check_tensor("log_c", resampled.log_c, (U,), f32, dev)
    check_tensor("use_unbiased", resampled.use_unbiased, (U,), torch.bool, dev)
    check_tensor("idx", idx, (2,), torch.int64, dev)
    if rho_both.dim() != 3:
        raise ValueError(f"rho_both must be (2, R, W), got {tuple(rho_both.shape)}")
    W = int(rho_both.shape[2])
    check_tensor("rho_both", rho_both, (2, R, W), f32, dev)
    check_tensor("log_p_control", log_p_control, (R, R), f32, dev)
    check_tensor("log_p_merged", log_p_merged, (2, 2), f32, dev)
    strides = (*_emission_strides("emission_control", emission_control, U, R, dev),
               *_emission_strides("emission_case", emission_case, U, R, dev))
    check_tensor("out_lw", out_lw, (U, N), f32, dev)
    check_tensor("out_parts", out_parts, (U, 5, N), i32, dev)
    if shifts.dim() != 2 or shifts.shape[0] != U or shifts.shape[1] < 1:
        raise ValueError(f"shifts must be ({U}, C), got {tuple(shifts.shape)}")
    check_tensor("shifts", shifts, tuple(shifts.shape), f32, dev)
    check_tensor("degen", degen, tuple(shifts.shape), torch.bool, dev)
    h_T = 0
    if hist is not None:
        if len(hist) != 6 or hist[0].dim() != 3:
            raise ValueError("hist must be six (U, T, N) tensors: the weights and the five fields")
        h_T = int(hist[0].shape[1])
        for k, (x, dt) in enumerate(zip(hist, HISTORY_DTYPES)):
            check_tensor(f"hist[{k}]", x, (U, h_T, N), dt, dev)
    if parents is not None:
        check_tensor("parents", parents, (U, M), torch.int64, dev)
    return U, N, R, W, strides, h_T


def filter_step_cuda(emission_control, emission_case, idx, prev_lw, prev_parts, resampled, M,
                     rho_both, log_p_control, log_p_merged, min_duration, out_lw, out_parts,
                     shifts, degen, hist=None, parents=None):
    """Launch K2 on the current stream for site t = idx[1]; no
    synchronisation.

    prev_lw (U, N) f32 and prev_parts (U, 5, N) int32: the renormalised
    carry; resampled: K1's ResampleResult for prev_lw; the emission tables
    (T, R) or (U, T, R) f32; rho_both (2, R, W), log_p_control (R, R),
    log_p_merged (2, 2) f32. Writes the new weights and particles into
    out_lw and out_parts (these may be prev_lw and prev_parts), the shift
    and degenerate flag into column idx[0] of shifts (U, C) f32 and degen
    (U, C) bool, row t of the history's six (U, T, N) tensors when given
    (HISTORY_DTYPES), and the (U, M) int64 parents when given. Raises
    where the kernel cannot go (``check_inputs``)."""
    dev = prev_lw.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA filter step needs CUDA tensors, got {dev}")
    U, N, R, W, strides, h_T = check_inputs(
        emission_control, emission_case, idx, prev_lw, prev_parts, resampled, M, rho_both, log_p_control,
        log_p_merged, out_lw, out_parts, shifts, degen, hist, parents)
    M = int(M)
    lib = KERNEL.load()
    ptr = lambda x: None if x is None else x.data_ptr()
    args = _Args(
        idx.data_ptr(), prev_lw.data_ptr(), prev_parts.data_ptr(), resampled.parent_indices.data_ptr(),
        resampled.top_m_indices.data_ptr(), resampled.log_c.data_ptr(), resampled.use_unbiased.data_ptr(),
        emission_control.data_ptr(), emission_case.data_ptr(), *strides,
        rho_both.data_ptr(), log_p_control.data_ptr(), log_p_merged.data_ptr(), out_lw.data_ptr(),
        out_parts.data_ptr(), shifts.data_ptr(), degen.data_ptr(), shifts.shape[1],
        *(ptr(x) for x in (hist if hist is not None else [None] * 6)), h_T, ptr(parents),
        U, N, M, R, W, int(min_duration), -math.log(float(M)), -math.log(float(N)),
    )
    with torch.cuda.device(dev):
        rc = lib.hygeia_filter_step(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        KERNEL.failed(rc)
    KERNEL.count()
