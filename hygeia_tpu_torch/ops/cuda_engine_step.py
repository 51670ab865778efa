"""K4, the single-group engine's site step after the resampler at a site at
capacity, as hand-written CUDA.

The kernels are ``hygeia_tpu_torch/csrc/engine_step.cu``, one launch a
stage, each over every unit of the site: WEIGHTS (a block a unit: the
ancestors from K1's outputs, the table lookups, the continuation and fresh
weights, the backward kernels B, the shift, and the new particles and
weights written in place), SMOOTH (a block a (unit, smoothing entry): the
psi mix, the insertion or spill, the means and second moments and the
finalised rows) and GRADIENT (a block a (unit, column of phi): phi's
mix plus the gradient term, and the score). What one stage hands the next
lies in a ``Workspace`` made once an engine. The plain version is
single_group/engine.py's ``_Engine._step_plain`` (with ``_smooth`` and
``_score``). On a CUDA card every site at capacity takes K4; an engine it
cannot take (weights other than float32, shapes beyond ``supports``) is
refused when it is made (``takes``). The growth phase and the CPU take the
plain version.

``engine_step_cuda`` raises on what the kernel cannot take; there is no
fallback to the plain version. ``KERNEL.launches`` counts every launch:
at a site at capacity WEIGHTS, then SMOOTH when regimes are estimated and
GRADIENT when parameters are.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from hygeia_tpu_torch.ops import cuda_backward_step  # noqa: F401  (K1, K2, K3 join build.KERNELS before K4)
from hygeia_tpu_torch.ops.build import SMEM_BUDGET, Kernel, check_tensor

WEIGHTS, SMOOTH, GRADIENT = 0, 1, 2  # the kernel's stages
MAX_REGIMES = 8  # kMaxR


def smem_bytes(n, r):
    """(WEIGHTS, SMOOTH, GRADIENT) dynamic shared memory of one block, as
    the kernel lays it out: seven floats, four ints and a byte a particle;
    the entry at t - 1, B and the entry at t; a column of phi."""
    return 45 * n, 12 * r * n, 4 * n


def supports(n, s, r, d):
    """None when K4 takes N particles, S smoothing entries, R regimes and D
    parameters, else the bound that refuses them. Needs no card."""
    if not 1 <= r <= MAX_REGIMES:
        return f"the CUDA engine step keeps a regime's sums in registers: R must be in [1, {MAX_REGIMES}], got R={r}"
    if n <= r:
        return f"the CUDA engine step needs N > R, got N={n}, R={r}"
    if s < 1:
        return f"the CUDA engine step needs S >= 1 smoothing entries, got S={s}"
    if d not in (r * r, r * (r + 1)):
        return f"the CUDA engine step needs D = R^2 or R(R + 1) = {r * r} or {r * (r + 1)}, got D={d}"
    most = max(smem_bytes(n, r))
    if most > SMEM_BUDGET:
        return (
            f"the CUDA engine step stages a unit's particles in shared memory: N={n}, R={r} needs "
            f"{most} bytes, more than the {SMEM_BUDGET} an H100 block may opt in to"
        )
    return None


def takes(device, dtype, n, s, r, d):
    """The route of an engine on ``device`` with ``dtype`` weights and these
    shapes: True on a CUDA device, whose sites at capacity take K4; False
    elsewhere, where every site takes the plain version. Raises for a
    CUDA engine that K4 cannot take: nothing on the card falls back to the
    plain version. Needs no card."""
    if torch.device(device).type != "cuda":
        return False
    if dtype != torch.float32:
        raise TypeError(f"the CUDA engine step takes float32 weights, got {dtype}")
    refused = supports(n, s, r, d)
    if refused:
        raise ValueError(refused)
    return True


class Workspace(NamedTuple):
    """What one stage hands the next, per unit."""

    b: torch.Tensor  # (U, R, N) f32: the backward kernels B
    w_self: torch.Tensor  # (U, N) f32: exp of the new weights, 0 where not finite
    anc: torch.Tensor  # (U, M) int32: the ancestors
    prev_code: torch.Tensor  # (U, N) int32: t - 1's regime where its sojourn reaches u, else -1
    g_prev: torch.Tensor  # (U, 2, N) f32: grad omega, grad kappa of log rho at t - 1's particles
    g_anc: torch.Tensor  # (U, 2, M) f32: a continuation's omega and kappa gradient terms
    slot: torch.Tensor  # (U, 2) int32: the insertion slot, and whether it was free


def workspace(n_units, n, r, device):
    """A Workspace for U units of N particles and R regimes."""
    U, M = int(n_units), int(n) - int(r)
    f32, i32 = torch.float32, torch.int32
    return Workspace(
        b=torch.zeros((U, r, n), dtype=f32, device=device),
        w_self=torch.zeros((U, n), dtype=f32, device=device),
        anc=torch.zeros((U, M), dtype=i32, device=device),
        prev_code=torch.zeros((U, n), dtype=i32, device=device),
        g_prev=torch.zeros((U, 2, n), dtype=f32, device=device),
        g_anc=torch.zeros((U, 2, M), dtype=f32, device=device),
        slot=torch.zeros((U, 2), dtype=i32, device=device),
    )


class _Args(ctypes.Structure):
    """The kernel's EngineStepArgs, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "t_dev", "d", "r", "w", "k1_parents", "k1_new_lw", "k1_top", "k1_unbiased", "haz", "log_p", "p",
        "emis")] + [
        ("e_su", ctypes.c_int64), ("e_st", ctypes.c_int64)] + [
        (name, ctypes.c_void_p) for name in (
            "live", "final_mask", "psi", "psi_time", "psi_valid", "out", "out_valid", "spill", "shifts", "phi",
            "score", "b", "w_self", "anc", "prev_code", "g_prev", "g_anc", "slot")] + [
        ("T", ctypes.c_int64)] + [
        (name, ctypes.c_int) for name in (
            "stage", "U", "N", "M", "R", "W", "S", "D", "n_haz", "min_duration", "regimes", "final_all")] + [
        ("epsilon", ctypes.c_float)]


KERNEL = Kernel("engine_step", args=_Args)

# The engine's state that K4 reads or writes: (dtype, shape) from (U, N, R,
# S, D, T).
_STATE = {
    "d": (torch.int64, lambda U, N, R, S, D, T: (U, N)),
    "r": (torch.int64, lambda U, N, R, S, D, T: (U, N)),
    "w": (torch.float32, lambda U, N, R, S, D, T: (U, N)),
    "psi": (torch.float32, lambda U, N, R, S, D, T: (U, S, R, N)),
    "psi_time": (torch.int64, lambda U, N, R, S, D, T: (U, S)),
    "psi_valid": (torch.bool, lambda U, N, R, S, D, T: (U, S)),
    "out": (torch.float32, lambda U, N, R, S, D, T: (U, T + 1, R)),
    "out_valid": (torch.bool, lambda U, N, R, S, D, T: (U, T + 1)),
    "spill": (torch.int64, lambda U, N, R, S, D, T: (U,)),
    "shifts": (torch.float32, lambda U, N, R, S, D, T: (U, T)),
    "phi": (torch.float32, lambda U, N, R, S, D, T: (U, N, D)),
    "score": (torch.float32, lambda U, N, R, S, D, T: (U, D)),
}


def check_inputs(state, resampled, tables, emissions, ws, t_dev, live=None, final=False):
    """The launch's shapes, as ``engine_step_cuda`` takes its arguments:
    (U, N, M, R, W, S, D, n_haz, T, emission strides (unit, site)); raises
    ValueError or TypeError naming the first argument the kernel cannot
    take. Every tensor must be on the weights' device; the device's type
    is not checked here, so this runs on the CPU."""
    w = state["w"]
    if w.dim() != 2:
        raise ValueError(f"state['w'] must be (U, N), got {tuple(w.shape)}")
    dev = w.device
    U, N = w.shape
    haz, log_p, p = tables
    if log_p.dim() != 3:
        raise ValueError(f"log_p must be (U, R, R), got {tuple(log_p.shape)}")
    R = int(log_p.shape[-1])
    psi, phi, shifts = state["psi"], state["phi"], state["shifts"]
    if psi.dim() != 4 or phi.dim() != 3 or shifts.dim() != 2:
        raise ValueError(f"state['psi'], ['phi'] and ['shifts'] must be (U, S, R, N), (U, N, D) and (U, T), got "
                         f"{tuple(psi.shape)}, {tuple(phi.shape)} and {tuple(shifts.shape)}")
    S, D, T = int(psi.shape[1]), int(phi.shape[2]), int(shifts.shape[1])
    refused = supports(N, S, R, D)
    if refused:
        raise ValueError(refused)
    if T >= 2**31 - 1:
        raise ValueError(f"the CUDA engine step keeps sojourns in 32 bits: T must be below 2**31 - 1, got T={T}")
    M = N - R
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    for name, (dtype, shape) in _STATE.items():
        check_tensor(f"state[{name!r}]", state[name], shape(U, N, R, S, D, T), dtype, dev)
    check_tensor("parent_indices", resampled.parent_indices, (U, M), i32, dev)
    check_tensor("new_log_weights", resampled.new_log_weights, (U, M), f32, dev)
    check_tensor("top_m_indices", resampled.top_m_indices, (U, M), i32, dev)
    check_tensor("use_unbiased", resampled.use_unbiased, (U,), torch.bool, dev)
    if haz.dim() != 3 or haz.shape[1] not in (3, 4) or haz.shape[2] % R:
        raise ValueError(f"haz must be (U, 3 or 4, R * W), got {tuple(haz.shape)}")
    n_haz, W = int(haz.shape[1]), int(haz.shape[2]) // R
    if (n_haz == 4) != (D == R * (R + 1)):
        raise ValueError(f"haz has {n_haz} tables, D={D} parameters: 4 tables go with kappa estimated, D = R(R + 1)")
    check_tensor("haz", haz, (U, n_haz, R * W), f32, dev)
    check_tensor("log_p", log_p, (U, R, R), f32, dev)
    check_tensor("p", p, (U, R, R), f32, dev)
    if emissions.device != dev:
        raise ValueError(f"emissions is on {emissions.device}, expected {dev}")
    if emissions.dtype != f32:
        raise TypeError(f"emissions has dtype {emissions.dtype}, expected {f32}")
    if tuple(emissions.shape) != (U, T, R) or emissions.stride(-1) != 1:
        raise ValueError(f"emissions must be a ({U}, {T}, {R}) view with contiguous regimes, got shape "
                         f"{tuple(emissions.shape)}, strides {emissions.stride()}")
    check_tensor("ws.b", ws.b, (U, R, N), f32, dev)
    check_tensor("ws.w_self", ws.w_self, (U, N), f32, dev)
    check_tensor("ws.anc", ws.anc, (U, M), i32, dev)
    check_tensor("ws.prev_code", ws.prev_code, (U, N), i32, dev)
    check_tensor("ws.g_prev", ws.g_prev, (U, 2, N), f32, dev)
    check_tensor("ws.g_anc", ws.g_anc, (U, 2, M), f32, dev)
    check_tensor("ws.slot", ws.slot, (U, 2), i32, dev)
    check_tensor("t_dev", t_dev, (1,), i64, dev)
    if live is not None:
        check_tensor("live", live, (T, U), torch.bool, dev)
    if torch.is_tensor(final):
        check_tensor("final", final, (U,), torch.bool, dev)
    elif not isinstance(final, bool):
        raise TypeError(f"final must be a bool or a (U,) bool tensor, got {type(final).__name__}")
    return U, N, M, R, W, S, D, n_haz, T, (emissions.stride(0), emissions.stride(1))


def engine_step_cuda(stage, state, resampled, tables, emissions, ws, t_dev, *, min_duration, epsilon,
                     regimes=True, live=None, final=False):
    """Launch K4's ``stage`` (WEIGHTS, SMOOTH or GRADIENT) on the current
    stream for site t = t_dev[0]; no synchronisation.

    state: the engine's dict (d, r, w, psi, psi_time, psi_valid, out,
    out_valid, spill, shifts, phi, score; written in place); resampled:
    K1's ResampleResult for state['w']; tables: (haz (U, n_haz, R * W),
    log_p (U, R, R), p (U, R, R)) f32; emissions (U, T, R) f32 (a unit
    stride of 0 shares one table); ws: the Workspace; t_dev (1,) int64.
    ``regimes``: whether WEIGHTS picks the smoothing buffer's insertion
    slot (SMOOTH needs it); ``live``: None or the (T, U) bool rows of the
    units not yet past their t_limit; ``final``: whether every pending
    entry finalises, a bool or a (U,) bool tensor. Each launch counts in
    ``KERNEL``. Raises where the kernel cannot go
    (``check_inputs``)."""
    dev = state["w"].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA engine step needs CUDA tensors, got {dev}")
    if stage not in (WEIGHTS, SMOOTH, GRADIENT):
        raise ValueError(f"stage must be WEIGHTS, SMOOTH or GRADIENT, got {stage!r}")
    U, N, M, R, W, S, D, n_haz, T, (e_su, e_st) = check_inputs(
        state, resampled, tables, emissions, ws, t_dev, live, final)
    lib = KERNEL.load()
    ptr = lambda x: None if x is None else x.data_ptr()
    st = state
    args = _Args(
        t_dev.data_ptr(), st["d"].data_ptr(), st["r"].data_ptr(), st["w"].data_ptr(),
        resampled.parent_indices.data_ptr(), resampled.new_log_weights.data_ptr(),
        resampled.top_m_indices.data_ptr(), resampled.use_unbiased.data_ptr(),
        *(x.data_ptr() for x in tables), emissions.data_ptr(), e_su, e_st,
        ptr(live), final.data_ptr() if torch.is_tensor(final) else None,
        *(st[k].data_ptr() for k in ("psi", "psi_time", "psi_valid", "out", "out_valid", "spill", "shifts",
                                     "phi", "score")),
        *(x.data_ptr() for x in ws), T,
        stage, U, N, M, R, W, S, D, n_haz, int(min_duration), int(bool(regimes)),
        int(final is True), float(epsilon),
    )
    with torch.cuda.device(dev):
        rc = lib.hygeia_engine_step(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        KERNEL.failed(rc)
    KERNEL.count()
