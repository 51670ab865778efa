"""XLA's CPU float32 exp, log, log1p, lgamma and digamma, operation for
operation.

The JAX package's float32 single-group hazard tables come from XLA's CPU
backend, which expands these functions inline into fixed sequences of f32
adds, multiplies, subtracts and divides, ``floor``, ``abs`` and bit moves,
with no fast-math reassociation: Cephes' ``expf`` (XLA's own rewrite of
``exp``), Eigen's ``plog_float`` for ``log``, a rational approximation
near 0 for ``log1p`` and the Lanczos (g = 7, n = 9) series for ``lgamma``
and ``digamma``. LLVM then contracts a multiply whose one use is an add or
a subtract into a fused multiply-add (XLA's CPU backend allows FP-op
fusion, and x86-64 hosts with FMA take it; a host without FMA would give
JAX other bits). The
functions below replay those sequences with the same constants, in the
same order, with ``_fma`` where the compiled kernels have an FMA (read
from their disassembly). Every step is an exactly rounded IEEE 754
operation, so the results are XLA-CPU's bits on the CPU and on a CUDA card
alike.

Rules that keep them exact:

* a Python constant enters only as a float32-representable value, and a
  constant is never a divisor (PyTorch's CUDA division by a scalar
  multiplies by its reciprocal); ``_div`` divides tensor by tensor;
* no ``torch.exp``/``log``/``lgamma``, no fused op (``addcmul``, ``lerp``,
  ``pow``);
* XLA's CPU backend runs with denormals-are-zero and flush-to-zero, so
  subnormal inputs are read as 0 and subnormal results are flushed.

``lgamma``'s reflection branch (x < 0.5, reached by BetaBinomial shapes
below 0.5) calls the C library's ``sinf``, which XLA's CPU backend links
to; ``sin`` replays glibc's (its double-precision polynomials) on the
branch's domain [0, pi/2]. ``digamma`` is replayed for x >= 0.5 only: its
reflection branch takes PyTorch's ``sin`` and ``cos`` and is not bit for
bit.

``reduce_sum`` adds along one axis in the order XLA's CPU backend gives
``jnp.sum``.
"""

from __future__ import annotations

import torch

_F32 = torch.float32
_INF = float("inf")
_NAN = float("nan")

# Cephes expf, as XLA emits it.
_EXP_LO = -87.80000305175781
_EXP_HI = 88.80000305175781
_LOG2E = 1.4426950216293335
_LN2_HI = 0.693359375
_LN2_LO = -0.00021219444170128554
_EXP_P = (0.00019875691214110702, 0.001398199936375022, 0.008333452045917511,
          0.04166579619050026, 0.1666666567325592)

# Eigen plog_float.
_MIN_NORMAL = 1.1754943508222875e-38
_SQRT_HALF = 0.7071067690849304
_LOG_P = (0.07037683576345444, -0.11514610052108765, 0.11676998436450958,
          -0.12420140951871872, 0.14249323308467865, -0.16668057441711426,
          0.2000071406364441, -0.24999994039535522, 0.3333333134651184)

# log1p near 0: x - x^2/2 + x^3 * Q(x) / P(x).
_LOG1P_SMALL = 0.4142135679721832
_LOG1P_P = (15.062909126281738, 83.04756927490234, 221.7624053955078,
            309.0987243652344, 216.42788696289062, 60.11865997314453)
_LOG1P_Q = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
            29.91191864013672, 60.949668884277344, 57.11296463012695,
            20.039552688598633)

# Lanczos series (g = 7); the f32 base coefficient rounds to 1.
_LANCZOS = (676.5203857421875, -1259.13916015625, 771.3234252929688,
            -176.6150360107422, 12.507343292236328, -0.138571098446846,
            9.984369171434082e-06, 1.5056326674312004e-07)
_INV_G_HALF = 0.13333334028720856  # 1 / 7.5
_LOG_G_HALF = 2.0149030685424805  # log(7.5)
_LOG_SQRT_2PI = 0.9189385175704956
_LOG_PI = 1.1447298526763916
_PI = 3.1415927410125732


# glibc's sinf (sysdeps/ieee754/flt-32/s_sinf.c, __sincosf_table[0]).
_SINF_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")  # 2/pi * 2**24
_SINF_HPI = float.fromhex("0x1.921FB54442D18p0")
_SINF_C = tuple(float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_SINF_S = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7", "-0x1.994eb3774cf24p-13"))
_ABSTOP12_PIO4 = 0x3F4  # top 12 bits of float32 pi/4
_ABSTOP12_TINY = 0x398  # top 12 bits of float32 2**-12

# XLA's CPU backend splits a sum over more than this many elements into
# windows of this size (its tree-reduction rewrite).
_REDUCE_WINDOW = 32


def _flush(v):
    """Subnormal float32 values to zero (XLA's DAZ/FTZ)."""
    return torch.where(v.abs() < _MIN_NORMAL, 0.0, v)


def _fma(a, b, c):
    """a * b + c rounded once to float32, as the FMA instructions XLA's CPU
    backend contracts a multiply and its one add into. In float64 the
    product is exact; the sum is rounded to odd (a TwoSum error term sets
    the last bit when the sum is inexact), and rounding that to float32
    is the correctly rounded result (53 >= 24 + 2 bits)."""
    p = a.double() * (b.double() if torch.is_tensor(b) else b)
    c = c.double() if torch.is_tensor(c) else torch.full_like(p, c)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + step, bits)
    return bits.view(torch.float64).to(_F32)


def _div(num, den):
    """num / den, correctly rounded on every device; num may be a constant."""
    if not torch.is_tensor(num):
        num = torch.full_like(den, num)
    return num / den


def exp(x):
    """XLA-CPU's float32 exp."""
    x = _flush(x)
    x = torch.where(x < _EXP_LO, _EXP_LO, x)  # NaN passes, as in XLA
    x = torch.where(x > _EXP_HI, _EXP_HI, x)
    fx = torch.floor(_fma(x, _LOG2E, 0.5))
    fx = torch.where(fx < -127.0, -127.0, torch.where(fx > 127.0, 127.0, fx))
    r = _fma(-fx, _LN2_LO, _fma(-fx, _LN2_HI, x))
    y = _fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:] + (0.5,):
        y = _fma(y, r, c)
    y = 1.0 + _fma(y, r * r, r)
    fx_int = torch.nan_to_num(fx).to(torch.int32)
    pow2 = ((fx_int + 127) << 23).view(_F32)  # 2**-127 is 0, as in XLA
    return _flush(y * pow2)


def _log_core(x):
    """Eigen's plog_float for positive normal x (no special values)."""
    x = torch.where(x > _MIN_NORMAL, x, _MIN_NORMAL)
    bits = x.view(torch.int32)
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(_F32)  # in [0.5, 1)
    e = ((bits >> 23) - 127).to(_F32) + 1.0
    small = m < _SQRT_HALF
    xm = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - torch.where(small, 1.0, 0.0)
    x2 = xm * xm
    x3 = x2 * xm
    p0, p1, p2, p3, p4, p5, p6, p7, p8 = _LOG_P
    y = _fma(_fma(xm, p0, p1), xm, p2)
    y1 = _fma(_fma(xm, p3, p4), xm, p5)
    y2 = _fma(_fma(xm, p6, p7), xm, p8)
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _LN2_LO)
    xm = _fma(x2, -0.5, xm)
    return _fma(e, _LN2_HI, xm + y)


def _log_special(x, core):
    out = torch.where(x > 0.0, core, _NAN)
    out = torch.where(x == _INF, _INF, out)
    return torch.where(x == 0.0, -_INF, out)


def log(x):
    """XLA-CPU's float32 natural log."""
    x = _flush(x)
    return _log_special(x, _log_core(x))


def log1p(x):
    """XLA-CPU's float32 log(1 + x)."""
    x = _flush(x)
    u = x + 1.0
    large = _log_special(u, _log_core(u))
    x2 = x * x
    zero = x * 0.0
    p = zero + 1.0
    for c in _LOG1P_P:
        p = _fma(p, x, c)
    q = zero + _LOG1P_Q[0]
    for c in _LOG1P_Q[1:]:
        q = _fma(q, x, c)
    small = x + _fma(x2, -0.5, (x * x2) * _div(q, p))
    return torch.where(x.abs() < _LOG1P_SMALL, small, large)


def sin(y):
    """glibc's float32 ``sinf`` on [0, pi/2], which XLA's CPU ``sine`` calls.

    glibc evaluates it in double: below pi/4 (by the top 12 bits of y) the
    sine polynomial of y, above it the cosine polynomial of y - pi/2. Each
    double operation here is exactly rounded; glibc's build contracts some
    of them into FMAs, which moves the double result by an ulp at most and
    the float32 result only where that ulp straddles a float32 rounding
    boundary (on none of 300,000 test points)."""
    x = y.double()
    top = (y.view(torch.int32) >> 20) & 0x7FF
    x2 = x * x
    x3 = x * x2
    s = (x + x3 * _SINF_S[0]) + (x3 * x2) * (_SINF_S[1] + x2 * _SINF_S[2])
    n = torch.floor((torch.floor(x * _SINF_HPI_INV) + 2.0**23) * 2.0**-24)
    r = x - n * _SINF_HPI
    r2 = r * r
    r4 = r2 * r2
    c1, c2 = _SINF_C[0] + r2 * _SINF_C[1], _SINF_C[3] + r2 * _SINF_C[4]
    c = (c1 + r4 * _SINF_C[2]) + (r4 * r2) * c2
    out = torch.where((top < _ABSTOP12_PIO4) | (n == 0.0), s, c)
    return torch.where(top < _ABSTOP12_TINY, x, out).to(_F32)


def reduce_sum(x, dim):
    """Sum along ``dim`` in XLA's CPU order: left to right, except that an
    axis longer than 32 is first padded with zeros (half the padding in
    front, the odd one at the back) to whole windows of 32, each window
    summed left to right, then the window totals reduced the same way."""
    x = x.movedim(dim, 0)
    while x.shape[0] > _REDUCE_WINDOW:
        n = x.shape[0]
        w = -(-n // _REDUCE_WINDOW)
        pad = w * _REDUCE_WINDOW - n
        z = x.new_zeros((1, *x.shape[1:]))
        x = torch.cat([z.expand(pad // 2, *x.shape[1:]), x,
                       z.expand(pad - pad // 2, *x.shape[1:])])
        x = x.reshape(w, _REDUCE_WINDOW, *x.shape[1:]).movedim(1, 0)
        acc = x[0]
        for i in range(1, _REDUCE_WINDOW):
            acc = acc + x[i]
        x = acc
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def _lanczos_z(x):
    return torch.where(x < 0.5, -x, x - 1.0)


def _log_t(z):
    """log(z + 7.5) as log(7.5) + log1p(z / 7.5)."""
    return log1p(z * _INV_G_HALF) + _LOG_G_HALF


def lgamma(x):
    """XLA-CPU's float32 log|Gamma(x)|, bit for bit."""
    x = _flush(x)
    z = _lanczos_z(x)
    acc = _div(_LANCZOS[0], z + 1.0) + 1.0
    for i, c in enumerate(_LANCZOS[1:], start=2):
        term = _div(abs(c), z + float(i))
        acc = acc - term if c < 0 else term + acc
    log_t = _log_t(z)
    t = z + 7.5
    log_y = _fma(log_t, (z + 0.5) - _div(t, log_t), _LOG_SQRT_2PI) + log(acc)
    # Euler's reflection below 0.5.
    ax = x.abs()
    frac = ax - torch.floor(ax)
    frac = torch.where(frac > 0.5, 1.0 - frac, frac)
    log_sin = log(sin(frac * _PI))
    refl = torch.where(log_sin.abs() != _INF, (_LOG_PI - log_sin) - log_y, -log_sin)
    out = torch.where(x < 0.5, refl, log_y)
    return torch.where(ax == _INF, _INF, out)


def digamma(x):
    """XLA-CPU's float32 digamma, bit for bit for x >= 0.5."""
    x = _flush(x)
    z = _lanczos_z(x)
    zk = z + 1.0
    num = 0.0 - _div(_LANCZOS[0], zk * zk)
    den = _div(_LANCZOS[0], zk) + 1.0
    for i, c in enumerate(_LANCZOS[1:], start=2):
        zk = z + float(i)
        sq, lin = _div(abs(c), zk * zk), _div(abs(c), zk)
        num = num + sq if c < 0 else num - sq
        den = den - lin if c < 0 else lin + den
    y = (_log_t(z) + _div(num, den)) - _div(7.0, z + 7.5)
    # Reflection below 0.5 (PyTorch's sin and cos: not bit for bit).
    w = (x + torch.floor(x + 0.5).abs()) * _PI
    refl = y - _div(torch.cos(w) * _PI, torch.sin(w))
    out = torch.where(x < 0.5, refl, y)
    return torch.where((x <= 0.0) & (x == torch.floor(x)), _NAN, out)


def inv_logit(x):
    """1 / (1 + exp(-x)), as the JAX package's ``inv_logit`` in float32."""
    return _div(1.0, 1.0 + exp(-x))
