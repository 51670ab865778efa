"""The yardstick's numbers: the card's published peaks, its power limit,
and the bytes and operations of the port's hand-written kernels.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its
full 700 W): HBM3 at 3.35 TB/s, 67 TFLOP/s in float32 outside the tensor
cores. A card set below 700 W runs slower under load; ``card()`` reads
its limit so that every result carries it.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def k1_bytes(units, n, m):
    """Bytes one launch of the optimal resampler (K1,
    ``csrc/optimal_resampling.cu``) must move for ``units`` rows of N
    weights and M offspring: each input read once (the N f32 log weights,
    the systematic uniform, the M multinomial uniforms) and each output
    written once (M parents, M new weights, M top indices, log c, the
    fallback flag)."""
    return units * (4 * n + 4 + 4 * m + 12 * m + 5)


def k1_bound_s(units, n, m):
    """The least time a K1 launch can take. Memory sets it: even at 24
    operations a weight, 24 N / 67 TFLOP/s is below 4 N / 3.35 TB/s."""
    return max(k1_bytes(units, n, m) / HBM_BYTES_PER_S, 24 * units * n / F32_FLOP_PER_S)


def card():
    """{"name", "power_limit_w"} of the first card, from nvidia-smi; the
    values are None where nvidia-smi cannot be run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
        name, limit = (s.strip() for s in out[0].split(","))
        return {"name": name, "power_limit_w": float(limit)}
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return {"name": None, "power_limit_w": None}
