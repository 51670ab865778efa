"""Change-point hazard tables rho(d, r) and their theta-gradients.

Counterpart of hygeia_tpu/ops/hazard.py: the single-group tables
(``hazard_table``, ``hazard_table_with_grads``) and the two-group one
(``rho_two_group``, ``gather_rho``).

Single-group tables: the same bits on every device
---------------------------------------------------
Past the exit latch ``big_h_prev >= 1`` the model forces a change point, and
in float32 that latch sits on a knife edge: the exclusive sum of the
sojourn pmf approaches 1 from below and crosses it, or not, by the rounding
of its last additions. Two rules make the port's tables bit-identical on
the CPU and on a CUDA card:

* every sum along the sojourn axis is an explicit order of elementwise
  adds (``_inclusive_scan``), never ``torch.cumsum``, whose order differs
  between devices. The order is the one XLA's CPU backend gives
  ``jnp.cumsum``: blocks of 16 summed left to right, the block totals
  scanned the same way, recursively, and the offsets added back;
* the pmf and its gradients come from operations that IEEE 754 rounds
  exactly on every device (add, multiply, divide, floor, bit moves), so no
  device's own ``lgamma``, ``exp`` or ``digamma`` enters a table.

In float32 the tables are the JAX package's bit for bit (its tables as
the CPU computes them op by op): the pmf, its gradients and the tables
follow ``hygeia_tpu/ops/hazard.py`` operation for operation, with XLA's
CPU ``exp``/``log``/``log1p``/``lgamma``/``digamma`` replayed by
``ops/xla_f32.py``, so the exit latch falls on JAX's columns. XLA's f32
``lgamma`` loses up to ~1e-3 relative in the deep tail (three lgammas of
~3e4 cancel); the port keeps that, as the latch depends on it.

In float64 the pmf and its gradients are computed from fdlibm's
algorithms written in exactly rounded operations (``_exp64``, ``_log64``,
``_log1p64``), the log-binomial coefficient as a sum of log1p terms and
the digamma difference as a sum of reciprocals: rtol 1e-12 of JAX's.

Two-group table
---------------

The survival function needs the regularised incomplete beta, which PyTorch
lacks. ``betainc`` below ports JAX's own implementation (the Lentz continued
fraction of jax/_src/lax/special.py, itself a port of XLA's math.cc) and
evaluates it in the table's dtype. That is load-bearing: in float32 the
survival function underflows in the deep tail and the reference's 0.1 guard
takes over from a sojourn that depends on the f32 evaluation itself, so a
table computed in f64 and cast would switch to the guard later than the JAX
package's f32 table does. In float32 the table is JAX-CPU's eager table
bit for bit: ``betainc`` replays XLA's compiled loop with ``xla_f32``'s
functions and the FMAs LLVM contracts there, and the log-pmf and the ratio
take ``xla_f32``'s lgamma, log, log1p and exp.
"""

from __future__ import annotations

import torch

from hygeia_tpu_torch.ops import xla_f32
from hygeia_tpu_torch.ops.distributions import neg_binomial_log_pmf

_NEG_INF = float("-inf")
# Matches fixed_value_inf of the reference two-group model.
_FIXED_VALUE_INF = 0.1
# The reference's clamp of the accumulated mass after the exit latch.
_BIG_H_CLAMP = 0.99999
# XLA's CPU backend rewrites a long cumulative sum into blocks of 16.
_SCAN_BLOCK = 16

# fdlibm constants (e_exp.c, e_log.c).
_LN2_HI = 6.93147180369123816490e-01
_LN2_LO = 1.90821492927058770002e-10
_INV_LN2 = 1.44269504088896338700e00
_EXP_P = (1.66666666666666019037e-01, -2.77777777770155933842e-03,
          6.61375632143793436117e-05, -1.65339022054652515390e-06,
          4.13813679705723846039e-08)
_LOG_LG = (6.666666666666735130e-01, 3.999999999940941908e-01,
           2.857142874366239149e-01, 2.222219843214978396e-01,
           1.818357216161805012e-01, 1.531383769920937332e-01,
           1.479819860511658591e-01)


# ---- float64 elementary functions from exactly rounded operations -------

def _pow2(k):
    """2**k for integer-valued float64 k in [-1022, 1023], built from bits."""
    return ((k.to(torch.int64) + 1023) << 52).view(torch.float64)


def _exp64(x):
    """exp of a float64 tensor, fdlibm's algorithm (< 1 ulp)."""
    xc = torch.clamp(x, -1080.0, 710.0)
    k = torch.round(xc * _INV_LN2)
    hi = xc - k * _LN2_HI  # k * _LN2_HI is exact for |k| < 2**20
    lo = k * _LN2_LO
    r = hi - lo
    t = r * r
    p1, p2, p3, p4, p5 = _EXP_P
    c = r - t * (p1 + t * (p2 + t * (p3 + t * (p4 + t * p5))))
    y = 1.0 - ((lo - (r * c) / (2.0 - c)) - hi)
    ka = torch.floor(k * 0.5)  # two factors keep each power of two normal
    out = y * _pow2(ka) * _pow2(k - ka)
    out = torch.where(x > 709.782712893384, float("inf"), out)
    out = torch.where(x < -745.1332191019412, 0.0, out)
    return torch.where(torch.isnan(x), x, out)


def _log64(x):
    """Natural log of a float64 tensor, fdlibm's algorithm (< 1 ulp)."""
    sub = x < 2.2250738585072014e-308
    xs = torch.where(sub, x * 18014398509481984.0, x)  # 2**54
    bits = xs.view(torch.int64)
    e = ((bits >> 52) & 0x7FF) - 1023 - torch.where(sub, 54, 0)
    m = ((bits & 0x000FFFFFFFFFFFFF) | 0x3FF0000000000000).view(torch.float64)
    big = m > 1.4142135623730951
    m = torch.where(big, m * 0.5, m)
    dk = (e + big.to(torch.int64)).to(torch.float64)
    f = m - 1.0
    s = f / (2.0 + f)
    z = s * s
    w = z * z
    lg1, lg2, lg3, lg4, lg5, lg6, lg7 = _LOG_LG
    t1 = w * (lg2 + w * (lg4 + w * lg6))
    t2 = z * (lg1 + w * (lg3 + w * (lg5 + w * lg7)))
    hfsq = 0.5 * f * f
    out = dk * _LN2_HI - ((hfsq - (s * (hfsq + (t2 + t1)) + dk * _LN2_LO)) - f)
    out = torch.where(x == 0.0, _NEG_INF, out)
    out = torch.where(x == float("inf"), float("inf"), out)
    return torch.where((x < 0.0) | torch.isnan(x), float("nan"), out)


def _log1p64(x):
    """log(1 + x) of a float64 tensor: log(u) * x / (u - 1) with u = 1 + x
    (Goldberg's correction of the rounding of u)."""
    u = 1.0 + x
    return torch.where(u == 1.0, x, _log64(u) * (x / (u - 1.0)))


def inv_logit64(x):
    """1 / (1 + exp(-x)) in float64, the same bits on every device."""
    return 1.0 / (1.0 + _exp64(-x.to(torch.float64)))


def exp64(x):
    """exp in float64, the same bits on every device."""
    return _exp64(x.to(torch.float64))


# ---- prefix sums in a fixed order ------------------------------------------

def _sequential_scan(x, exclusive=False):
    """Prefix sums along the last axis (<= 16 long), left to right."""
    cols = x.unbind(-1)
    acc = cols[0]
    out = [torch.zeros_like(acc), acc] if exclusive else [acc]
    for c in cols[1:-1] if exclusive else cols[1:]:
        acc = acc + c
        out.append(acc)
    return torch.stack(out, dim=-1)


def _block_offsets(totals):
    """Exclusive prefix sums of block totals, in XLA's order."""
    if totals.shape[-1] <= _SCAN_BLOCK:
        return _sequential_scan(totals, exclusive=True)
    inc = _inclusive_scan(totals)
    return torch.cat([torch.zeros_like(inc[..., :1]), inc[..., :-1]], dim=-1)


def _inclusive_scan(x):
    """Inclusive prefix sums along the last axis, in the order XLA's CPU
    backend sums ``jnp.cumsum``: zero-pad to a multiple of 16, sum each
    block of 16 left to right, add the block's offset (the exclusive sum of
    the block totals, found the same way, recursively)."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _sequential_scan(x)
    nb = -(-n // _SCAN_BLOCK)
    xp = torch.nn.functional.pad(x, (0, nb * _SCAN_BLOCK - n))
    blocks = _sequential_scan(xp.reshape(*x.shape[:-1], nb, _SCAN_BLOCK))
    out = blocks + _block_offsets(blocks[..., -1])[..., None]
    return out.reshape(*x.shape[:-1], nb * _SCAN_BLOCK)[..., :n]


def _exclusive_cumsum(x):
    """Exclusive prefix sums along the last axis (shift, then sum: no
    cumsum(x) - x cancellation when 1 - bigH is near an ulp)."""
    shifted = torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], dim=-1)
    return _inclusive_scan(shifted)


# ---- single-group hazard tables --------------------------------------------

def hazard_table_with_grads(kappa, omega, u, d_max, kappa_fixed=True, dtype=None):
    """C++-semantics hazard table plus d(log rho)/dtheta tables.

    kappa, omega: (..., R) tensors; the tables are (..., R, d_max) in
    ``dtype`` (default: the promoted dtype of kappa and omega, at least
    float32). Returns a dict with
      rho, exit_status                       the hazard and the exit latch
      grad_omega_log_rho                     w.r.t. logit(omega)
      grad_kappa_log_rho (or None)           w.r.t. log(kappa)

    For 0-based column c (sojourn d = c + 1) and x = d - u:
      little_h[c]   = NB(x; kappa, omega) for d >= u, else 0
      big_h_prev[c] = sum_{i<c} little_h[i]
      exit[c]       = any_{c'<=c} big_h_prev[c'] >= 1
      rho[c]        = 0 (d < u) | 1 (exit) | little_h[c] / (1 - big_h_prev[c])
    The gradient accumulators keep accumulating past the latch with the
    clamped denominator 1 - 0.99999; the kappa gradient uses the kappa
    accumulator (hygeia_tpu/ops/hazard.py:91-156).
    """
    if dtype is None:
        dtype = torch.promote_types(torch.promote_types(kappa.dtype, omega.dtype), torch.float32)
    if dtype == torch.float32:
        return _hazard_table_with_grads_f32(kappa, omega, u, d_max, kappa_fixed)
    dev = kappa.device
    f64 = torch.float64
    kap = kappa.to(f64)[..., None]
    om = omega.to(f64)[..., None]
    d = torch.arange(1, d_max + 1, dtype=f64, device=dev)
    x = torch.clamp(d - u, min=0.0)
    x_idx = x.to(torch.int64)
    live = d >= u

    # log C(x + kappa - 1, x) = sum_{i=1..x} log1p((kappa - 1) / i), and
    # digamma(x + kappa) - digamma(kappa) = sum_{i=0..x-1} 1 / (kappa + i).
    i = torch.arange(0, d_max, dtype=f64, device=dev)
    log_binom = _exclusive_cumsum(_log1p64((kap - 1.0) / (i + 1.0)))[..., x_idx]
    lp = log_binom + kap * _log1p64(-om) + x * _log64(om)
    lp = torch.where(om == 0.0, torch.where(x == 0.0, 0.0, _NEG_INF), lp)
    little_h64 = torch.where(live, _exp64(lp), 0.0)
    g_om64 = torch.where(live, (x / om - kap / (1.0 - om)) * om * (1.0 - om), 0.0)

    little_h = little_h64.to(dtype)
    big_h_prev = _exclusive_cumsum(little_h)
    exit_status = (big_h_prev >= 1.0).to(torch.uint8).cummax(dim=-1).values.bool()
    early = ~live
    rho = torch.where(early, 0.0, torch.where(exit_status, 1.0, little_h / (1.0 - big_h_prev)))
    denom = 1.0 - torch.where(exit_status, _BIG_H_CLAMP, big_h_prev)

    def grad_table(g64):
        acc = _exclusive_cumsum((little_h64 * g64).to(dtype))
        return torch.where(early, 0.0, g64.to(dtype) + acc / denom)

    grad_kappa = None
    if not kappa_fixed:
        dig = _exclusive_cumsum(1.0 / (kap + i))[..., x_idx]
        grad_kappa = grad_table(torch.where(live, kap * (dig - _log1p64(-om)), 0.0))
    return {
        "rho": rho,
        "exit_status": exit_status,
        "grad_omega_log_rho": grad_table(g_om64),
        "grad_kappa_log_rho": grad_kappa,
    }


def _hazard_table_with_grads_f32(kappa, omega, u, d_max, kappa_fixed):
    """The float32 tables in the JAX package's order of operations
    (``hygeia_tpu/ops/hazard.py::hazard_table_with_grads`` and
    ``ops/distributions.py::neg_binomial_log_pmf``), with XLA's CPU
    elementary functions: JAX-CPU's bits on every device."""
    f32 = torch.float32
    kap = kappa.to(f32)[..., None]
    om = omega.to(f32)[..., None]
    d = torch.arange(1, d_max + 1, dtype=f32, device=kappa.device)
    x = torch.clamp(d - u, min=0.0)
    live = d >= u
    lp = (((xla_f32.lgamma(x + kap) - xla_f32.lgamma(kap)) - xla_f32.lgamma(x + 1.0))
          + kap * xla_f32.log1p(-om)) + x * xla_f32.log(om)
    lp = torch.where(om == 0.0, torch.where(x == 0.0, 0.0, _NEG_INF), lp)
    little_h = torch.where(live, xla_f32.exp(lp), 0.0)
    big_h_prev = _exclusive_cumsum(little_h)
    exit_status = (big_h_prev >= 1.0).to(torch.uint8).cummax(dim=-1).values.bool()
    early = ~live
    one = torch.ones_like(big_h_prev)
    rho = torch.where(early, 0.0, torch.where(exit_status, 1.0, little_h / (one - big_h_prev)))
    denom = one - torch.where(exit_status, _BIG_H_CLAMP, big_h_prev)

    def grad_table(g):
        g = torch.where(live, g, 0.0)
        return torch.where(early, 0.0, g + _exclusive_cumsum(little_h * g) / denom)

    one_om = 1.0 - om
    g_om = ((x / om - kap / one_om) * om) * one_om
    grad_kappa = None
    if not kappa_fixed:
        dig = xla_f32.digamma(x + kap) - xla_f32.digamma(kap)
        grad_kappa = grad_table(kap * (dig - xla_f32.log1p(-om)))
    return {
        "rho": rho,
        "exit_status": exit_status,
        "grad_omega_log_rho": grad_table(g_om),
        "grad_kappa_log_rho": grad_kappa,
    }


def hazard_table(kappa, omega, u, d_max, dtype=None):
    """(rho, exit_status), as ``hazard_table_with_grads`` gives them."""
    t = hazard_table_with_grads(kappa, omega, u, d_max, dtype=dtype)
    return t["rho"], t["exit_status"]


def _lentz(a, b, x, *, num_iterations, small):
    """Lentz-Thompson-Barnett evaluation of the incomplete-beta continued
    fraction (DLMF 8.17.22). Like XLA's loop, every element keeps iterating
    until ALL elements have converged, so the result does not depend on
    where each element alone would have stopped. In float32 the update
    ``d = 1 + num * d`` is one FMA, as in XLA's compiled loop."""
    f32 = x.dtype == torch.float32
    one = torch.ones_like(a)
    two = torch.full_like(a, 2.0)
    h = torch.full_like(x, small)  # partial denominator 0 is below `small`
    c = h
    d = torch.zeros_like(h)
    it = 1
    unconverged = True
    while it < num_iterations and unconverged:
        if it == 1:
            num = torch.ones_like(x)
        else:
            m = (it - 1) // 2
            if it % 2 == 0:
                if m == 0:
                    num = xla_f32._div(-(a + b) * x, a + one)
                else:
                    num = xla_f32._div(
                        -(a + m) * (a + b + m) * x, (a + two * m) * (a + two * m + one)
                    )
            else:
                num = xla_f32._div(m * (b - m) * x, (a + two * m - one) * (a + two * m))
        c = 1.0 + xla_f32._div(num, c)
        c = torch.where(c.abs() < small, small, c)
        d = xla_f32._fma(num, d, 1.0) if f32 else 1.0 + num * d
        d = torch.where(d.abs() < small, small, d)
        d = torch.reciprocal(d)
        delta = c * d
        h = h * delta
        it += 1
        # One host read per iteration; the table is built once per segment.
        unconverged = bool(((delta - 1.0).abs() >= small).any())
    return h


def _flush_subnormal(v):
    """Flush subnormal values to zero. XLA's CPU and TPU backends run with
    flush-to-zero, so the JAX table's survival function reaches 0, and the
    0.1 guard fires, as soon as it drops below the dtype's smallest normal
    number; PyTorch keeps subnormals, which would move the guard onset
    ~75 sojourns later in f32."""
    return torch.where(v.abs() < torch.finfo(v.dtype).tiny, 0.0, v)


def betainc(a, b, x):
    """Regularised incomplete beta I_x(a, b), elementwise, in x's dtype.

    In float32 it is XLA's CPU program bit for bit: ``xla_f32``'s
    functions, the FMAs LLVM contracts (the loop's ``d`` update and
    ``log(x) * a + log1p(-x) * b``), and XLA's flush-to-zero of the
    subnormal prefactor and result."""
    a, b, x = torch.broadcast_tensors(a, b, x)
    dtype = x.dtype
    finfo = torch.finfo(dtype)
    small = finfo.eps / 2
    inf = float("inf")

    a_is_zero = (a == 0) | (b == inf)
    b_is_zero = (b == 0) | (a == inf)
    x_is_zero = x == 0
    x_is_one = x == 1
    is_nan = torch.isnan(a) | torch.isnan(b) | torch.isnan(x)
    result_is_zero = (b_is_zero & ~x_is_one) | (a_is_zero & x_is_zero)
    result_is_one = (a_is_zero & ~x_is_zero) | (b_is_zero & x_is_one)
    result_is_nan = (a < 0) | (b < 0) | (x < 0) | (x > 1)
    result_is_nan = result_is_nan | (a_is_zero & b_is_zero) | is_nan

    # The fraction converges fast for x < (a+1)/(a+b+2); otherwise use the
    # symmetry I_x(a, b) = 1 - I_{1-x}(b, a) (DLMF 8.17.4).
    fast = x < xla_f32._div(a + 1.0, a + b + 2.0)
    a, b = torch.where(fast, a, b), torch.where(fast, b, a)
    x = torch.where(fast, x, 1.0 - x)

    cf = _lentz(
        a, b, x,
        num_iterations=200 if dtype == torch.float32 else 600,
        small=small,
    )
    very_small = finfo.tiny * 2
    if dtype == torch.float32:
        lgamma, exp, log, log1p = xla_f32.lgamma, xla_f32.exp, xla_f32.log, xla_f32.log1p
    else:
        lgamma, exp, log, log1p = torch.lgamma, torch.exp, torch.log, torch.log1p
    lbeta_small_a = lgamma(b) - lgamma(a + b)
    lbeta = lgamma(a) + lbeta_small_a
    log1p_x = log1p(-x)
    if dtype == torch.float32:
        big_a_arg = xla_f32._fma(log(x), a, log1p_x * b)
    else:
        big_a_arg = log(x) * a + log1p_x * b
    factor = torch.where(
        a < very_small,
        exp(log1p_x * b - lbeta_small_a),
        xla_f32._div(exp(big_a_arg - lbeta), a),
    )
    result = _flush_subnormal(cf * _flush_subnormal(factor))
    result = torch.where(fast, result, 1.0 - result)
    result = torch.where(result_is_zero, 0.0, result)
    result = torch.where(result_is_one, 1.0, result)
    return torch.where(result_is_nan, float("nan"), result)


def rho_two_group(kappa, omega, u, d_max):
    """Two-group hazard table rho[r, d-1] = h(d-u) / S(d-u-1), (R, d_max).

    h is the NB(kappa, omega) pmf and S its survival function,
    S(k-1) = I_omega(k, kappa). The reference's guards are kept:
      * rho = 0 where d < u (log h = -inf),
      * any non-finite rho replaced by 0.1 (the deep tail, where S
        underflows in the table's dtype).
    """
    dtype = torch.promote_types(torch.promote_types(kappa.dtype, omega.dtype), torch.float32)
    d = torch.arange(1, d_max + 1, dtype=dtype, device=kappa.device)[None, :]
    kappa_c = kappa.to(dtype)[:, None]
    omega_c = omega.to(dtype)[:, None]

    shifted = torch.clamp(d - u, min=0.0)
    log_h = torch.where(
        d >= u, neg_binomial_log_pmf(shifted, kappa_c, omega_c), _NEG_INF
    )
    surv_prev = betainc(torch.clamp(shifted, min=1.0), kappa_c, omega_c)
    f32 = dtype == torch.float32
    log_surv_prev = torch.where(d > u, (xla_f32.log if f32 else torch.log)(surv_prev), 0.0)
    rho = torch.where(
        log_h == _NEG_INF, 0.0, (xla_f32.exp if f32 else torch.exp)(log_h - log_surv_prev)
    )
    return torch.where(torch.isfinite(rho), rho, _FIXED_VALUE_INF)


def gather_rho(rho_table, d_prev, r_prev):
    """rho for (sojourn d_prev, regime r_prev), entry [r, d-1].

    The sojourn is clamped to the table depth. The regime is clamped too:
    dead particle slots carry regime -1, which torch would wrap to the last
    row; their value is never used (they carry -inf weights), and the clamp
    keeps the lookup in bounds without relying on wrap-around.
    """
    R, W = rho_table.shape
    d_idx = torch.clamp(d_prev.long() - 1, 0, W - 1)
    r_idx = torch.clamp(r_prev.long(), 0, R - 1)
    return rho_table[r_idx, d_idx]
