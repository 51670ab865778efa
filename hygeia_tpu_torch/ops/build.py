"""Build the port's CUDA kernels into one shared library, at first use.

Compiles every ``hygeia_tpu_torch/csrc/*.cu`` with nvcc for ``sm_90a``
(Hopper) into a shared library with a plain C interface, loaded with ctypes.
The library lands in ``hygeia_tpu_torch/_build/`` (listed in .gitignore),
named by a hash of the sources and flags, so an edited source is rebuilt and
an unchanged one is not. A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class BuildInfo(NamedTuple):
    """What a build did: the library's path, the seconds nvcc took (0 when
    an up-to-date library was found) and nvcc's stderr, which holds ptxas's
    register and shared-memory report."""

    path: Path
    seconds: float
    log: str


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH); "
            "the CUDA kernels of hygeia_tpu_torch are built on the machine with the GPU"
        )
    return found


def sources():
    return sorted(CSRC.glob("*.cu"))


def build_library() -> BuildInfo:
    """Compile csrc/*.cu into BUILD_DIR unless an up-to-date build exists."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {CSRC}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib = BUILD_DIR / f"libhygeia_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return BuildInfo(lib, 0.0, "")
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    return BuildInfo(lib, seconds, proc.stderr)


def load_library():
    """(ctypes.CDLL, BuildInfo) of the built kernel library."""
    info = build_library()
    return ctypes.CDLL(str(info.path)), info
