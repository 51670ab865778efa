"""Build the port's CUDA kernels, one shared library a source, at first use.

Compiles each ``hygeia_tpu_torch/csrc/<name>.cu`` with nvcc for ``sm_90a``
(Hopper) into a shared library with a plain C interface, loaded with ctypes.
The libraries land in ``hygeia_tpu_torch/_build/`` (listed in .gitignore),
each named by a hash of its source and the flags, so an edited source is
rebuilt and an unchanged one is not. ``build_all`` starts one nvcc a
source that needs it, all at once, and waits for them. A failed build
raises with nvcc's stderr.

What every hand kernel's wrapper shares lives here too: ``Kernel``, a
library loaded at first use with its launch count; ``KERNELS``, the
kernels counted through CUDA-graph replays; ``SMEM_BUDGET``, the shared
memory a block may opt in to; and ``check_tensor``, the check that names
a tensor a kernel cannot take.
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

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# The dynamic shared memory a block may opt in to on an H100 (sm_90:
# 227 KB, cudaDevAttrMaxSharedMemoryPerBlockOptin), less 1 KB for a
# kernel's static shared arrays (~200 B).
SMEM_BUDGET = 227 * 1024 - 1024


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


# Every kernel counted through replays (K1 in ops/cuda_resampling.py, K2 in
# ops/cuda_filter_step.py, K3 in ops/cuda_backward_step.py, K4 in
# ops/cuda_engine_step.py), in the order made: ops/site_graphs.py adds each one's captured launches to its count
# at every replay.
KERNELS = []


class Kernel:
    """csrc/<name>.cu's library, loaded at first use, and its launch count.

    ``load`` builds and loads the library once, then declares its C
    entries: ``declare(lib)``, the wrapper's own, sets their argtypes and
    returns the launch entry; or, with ``args`` (a ctypes.Structure, the
    kernel's <Name>Args field for field), the entry is
    ``hygeia_<name>(args*, stream)`` and the struct's size is held to
    ``hygeia_<name>_args_size()``. Every entry returns a CUDA error code,
    which ``error_string`` names (default ``hygeia_<name>_error_string``);
    ``failed`` raises with it.

    ``launches`` goes up by one per kernel launch, eager or replayed: the
    wrapper counts an eager launch (``count``), and a CUDA graph's replay
    adds the launches its capture recorded (ops/site_graphs.py).
    ``captured`` counts the launches that captures recorded, which run only
    when replayed. With ``counted`` the kernel joins KERNELS."""

    def __init__(self, name, declare=None, *, args=None, error_string=None, counted=True):
        self.name, self.args = name, args
        self._declare = declare
        self._error_string = error_string or f"hygeia_{name}_error_string"
        self.lib = None
        self.build = None
        self.launch = None  # the C entry, argtypes set
        self.launches = 0
        self.captured = 0
        if counted:
            KERNELS.append(self)

    def load(self):
        if self.lib is None:
            lib, info = load_library(self.name)
            error_string = getattr(lib, self._error_string)
            error_string.argtypes, error_string.restype = [ctypes.c_int], ctypes.c_char_p
            if self.args is None:
                launch = self._declare(lib)
            else:
                launch = getattr(lib, f"hygeia_{self.name}")
                launch.argtypes, launch.restype = [ctypes.POINTER(self.args), ctypes.c_void_p], ctypes.c_int
                size = getattr(lib, f"hygeia_{self.name}_args_size")
                size.restype = ctypes.c_size_t
                if size() != ctypes.sizeof(self.args):
                    struct = "".join(w.capitalize() for w in self.name.split("_")) + "Args"
                    raise RuntimeError(f"csrc/{self.name}.cu's {struct} and {self.args.__name__} differ in size")
            self.lib, self.build, self.launch = lib, info, launch
        return self.lib

    def failed(self, rc):
        """Raise for the nonzero error code ``rc`` of a launch."""
        msg = getattr(self.lib, self._error_string)(rc).decode()
        raise RuntimeError(f"{self.name} kernel launch failed: {msg} ({rc})")

    def count(self):
        """Count one launch: now, or at each replay when a graph is being
        captured."""
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1


def check_tensor(name, t, shape, dtype, device):
    """Raise ValueError or TypeError naming ``name`` unless ``t`` is a
    contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
