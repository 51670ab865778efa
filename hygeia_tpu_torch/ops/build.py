"""Build the port's CUDA kernels, one shared library a source, at first use.

Compiles each ``hygeia_tpu_torch/csrc/<name>.cu`` with nvcc for ``sm_90a``
(Hopper) into a shared library with a plain C interface, loaded with ctypes.
The libraries land in ``hygeia_tpu_torch/_build/`` (listed in .gitignore),
each named by a hash of its source and the flags, so an edited source is
rebuilt and an unchanged one is not. ``build_all`` starts one nvcc a
source that needs it, all at once, and waits for them. A failed build
raises with nvcc's stderr.
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


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.name.encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"libhygeia_{src.stem}_{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """{name: BuildInfo} for csrc/<name>.cu of every name (default: every
    source). The sources without an up-to-date library are compiled by one
    nvcc each, all started together; each BuildInfo's seconds runs from the
    start to its nvcc's collection, in source order (so a later source's
    includes the wait for the earlier ones)."""
    srcs = sources() if names is None else [CSRC / f"{n}.cu" for n in names]
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {CSRC}")
    for src in srcs:
        if not src.exists():
            raise RuntimeError(f"no CUDA source {src}")
    out, jobs = {}, []
    for src in srcs:
        lib = _target(src)
        if lib.exists():
            out[src.stem] = BuildInfo(lib, 0.0, "")
        else:
            jobs.append((src, lib))
    if not jobs:
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for src, lib in jobs:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((src, lib, tmp, cmd, proc, time.perf_counter()))
    failed = []
    for src, lib, tmp, cmd, proc, t0 in running:
        _, err = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{err}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
        out[src.stem] = BuildInfo(lib, seconds, err)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build_library(name="optimal_resampling") -> BuildInfo:
    """Compile csrc/<name>.cu into BUILD_DIR unless an up-to-date build exists."""
    return build_all([name])[name]


def load_library(name):
    """(ctypes.CDLL, BuildInfo) of csrc/<name>.cu's built library."""
    info = build_library(name)
    return ctypes.CDLL(str(info.path)), info
