"""Safeguarded Newton root finder (off the reference's main path).

Counterpart of hygeia_tpu/ops/newton.py (the reference's
findRoot::saveguardedNewton): Newton steps on a bracketing interval [lb,
ub], with the bisection midpoint wherever the Newton point leaves the
bracket or fails the endpoint sign test, the bracket shrunk every
iteration. The JAX module is a ``lax.while_loop``; here it is a plain loop
on float64 tensors with the reference loop's iterates, stops and
non-bracketing return. (XLA compiles the JAX loop's body and may contract
f's multiplies and adds into FMAs, so its iterates can differ from the
reference's in the last bits.) Each stop test reads the iterate on the
host.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def safeguarded_newton(
    f: Callable,
    f1: Callable,
    lb,
    ub,
    *,
    tol_x: float = 1e-12,
    tol_f: float = 1e-12,
    n_iterations: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A root of f in the bracketing interval [lb, ub]: (x, is_bracketing),
    0-d float64 and bool tensors.

    If f(lb) f(ub) > 0 the interval does not bracket a root: is_bracketing
    is False and x = lb. Otherwise iterate until |a - b| <= tol_x or
    |f(x)| <= tol_f or n_iterations steps (at least one step); a step takes
    the Newton point x1 = x - f(x) / f'(x) when it lies strictly inside (a,
    b) and f(a) f(x1) < 0 or f(b) f(x1) < 0, else the midpoint, then
    replaces the bracket end whose f has the new point's sign.

    ``f`` and ``f1`` map a 0-d float64 tensor to a 0-d tensor."""
    lb = torch.as_tensor(lb, dtype=torch.float64)
    ub = torch.as_tensor(ub, dtype=torch.float64)
    fa = f(lb)
    fb = f(ub)
    is_bracketing = fa * fb <= 0
    if not bool(is_bracketing):
        return lb, is_bracketing
    a, b, x = lb, ub, lb
    fx = fa
    i = 0
    while i == 0 or (bool(torch.abs(a - b) > tol_x) and bool(torch.abs(fx) > tol_f) and i < n_iterations):
        x1 = x - fx / f1(x)
        fx1 = f(x1)
        take_newton = ((fa * fx1 < 0) | (fb * fx1 < 0)) & (a < x1) & (x1 < b)
        mid = (a + b) / 2
        x = torch.where(take_newton, x1, mid)
        fx = torch.where(take_newton, fx1, f(mid))
        shrink_upper = fa * fx <= 0
        a, fa = torch.where(shrink_upper, a, x), torch.where(shrink_upper, fa, fx)
        b, fb = torch.where(shrink_upper, x, b), torch.where(shrink_upper, fx, fb)
        i += 1
    return x, is_bracketing
