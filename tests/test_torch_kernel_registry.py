"""The hand kernels' shared loader and launch registry (ops/build.py) on
the CPU: K1, K2, K3 and K4 join the registry once each, in that order,
whatever module is imported first; the site loops count through that
registry; no wrapper reaches into another's private names; and a failed
launch or a struct that differs from its kernel's raises with the
wrapper's text. The libraries are stood in for by a fake: nothing here
builds or loads CUDA code."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

from hygeia_tpu_torch.ops import build, probe, site_graphs
from hygeia_tpu_torch.ops import cuda_backward_step as k3
from hygeia_tpu_torch.ops import cuda_engine_step as k4
from hygeia_tpu_torch.ops import cuda_filter_step as k2
from hygeia_tpu_torch.ops import cuda_resampling as k1

REPO = Path(__file__).resolve().parent.parent
OPS = REPO / "hygeia_tpu_torch" / "ops"
WRAPPERS = [(k1.KERNEL, "optimal_resampling"), (k2.KERNEL, "filter_step"), (k3.KERNEL, "backward_step"),
            (probe.PROBE, "probe"), (k4.KERNEL, "engine_step")]


def test_the_three_kernels_join_the_registry_once_in_order():
    ours = [k for k in build.KERNELS if k in (k1.KERNEL, k2.KERNEL, k3.KERNEL)]
    assert ours == [k1.KERNEL, k2.KERNEL, k3.KERNEL]
    assert probe.PROBE not in build.KERNELS
    assert site_graphs.KERNELS is build.KERNELS


@pytest.mark.parametrize("first", ["cuda_engine_step", "cuda_backward_step", "site_graphs"])
def test_k4_joins_the_registry_after_k3_whatever_is_imported_first(first):
    code = (f"import hygeia_tpu_torch.ops.{first}\n"
            "from hygeia_tpu_torch.single_group import runner\n"
            "from hygeia_tpu_torch.ops import build\n"
            "print([k.name for k in build.KERNELS])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True,
                         timeout=300).stdout
    assert out.strip() == "['optimal_resampling', 'filter_step', 'backward_step', 'engine_step']"


@pytest.mark.parametrize("first", ["cuda_backward_step", "cuda_filter_step", "site_graphs"])
def test_the_registry_order_does_not_depend_on_the_first_import(first):
    code = (f"import hygeia_tpu_torch.ops.{first}\n"
            "from hygeia_tpu_torch.two_group import runner\n"
            "from hygeia_tpu_torch.ops import build\n"
            "print([k.name for k in build.KERNELS])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True,
                         timeout=300).stdout
    assert out.strip() == "['optimal_resampling', 'filter_step', 'backward_step']"


def test_no_ops_module_imports_a_private_name_of_another():
    for path in sorted(OPS.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("hygeia_tpu_torch.ops"):
                private = [a.name for a in node.names if a.name.startswith("_")]
                assert not private, f"{path.name} imports {private} from {node.module}"
    assert "class " not in (OPS / "probe.py").read_text()


class _Fn:
    def __init__(self, value):
        self.value = value

    def __call__(self, *args):
        return self.value


class _Lib:
    """A stand-in library: every entry returns 0, an error string names
    its code, and an args-size entry returns ``size``."""

    def __init__(self, size=0):
        self.size = size

    def __getattr__(self, name):
        if name.endswith("_error_string"):
            fn = lambda rc: f"error {rc}".encode()
        else:
            fn = _Fn(self.size if name.endswith("_args_size") else 0)
        setattr(self, name, fn)
        return fn


@pytest.mark.parametrize("kernel, name", WRAPPERS, ids=[n for _, n in WRAPPERS])
def test_a_failed_launch_raises_with_the_kernel_name_and_code(monkeypatch, kernel, name):
    monkeypatch.setattr(kernel, "lib", _Lib())
    with pytest.raises(RuntimeError, match=re.escape(f"{name} kernel launch failed: error 700 (700)")):
        kernel.failed(700)


@pytest.mark.parametrize("module, struct", [(k2, "FilterStepArgs"), (k3, "BackwardStepArgs"),
                                            (k4, "EngineStepArgs")])
def test_a_struct_of_another_size_than_the_kernels_is_refused(monkeypatch, module, struct):
    kernel, name = module.KERNEL, module.KERNEL.name
    for attr in ("lib", "build", "launch"):
        monkeypatch.setattr(kernel, attr, None)
    monkeypatch.setattr(build, "load_library", lambda n: (_Lib(size=1), build.BuildInfo(Path(n), 0.0, "")))
    with pytest.raises(RuntimeError, match=re.escape(f"csrc/{name}.cu's {struct} and _Args differ in size")):
        kernel.load()
    assert kernel.lib is None

    import ctypes

    lib = _Lib(size=ctypes.sizeof(module._Args))
    monkeypatch.setattr(build, "load_library", lambda n: (lib, build.BuildInfo(Path(n), 0.0, "")))
    assert kernel.load() is lib and kernel.launch is getattr(lib, f"hygeia_{name}")


def test_k1_declares_its_positional_entry_and_the_empty_launch(monkeypatch):
    import ctypes

    for attr in ("lib", "build", "launch"):
        monkeypatch.setattr(k1.KERNEL, attr, None)
    lib = _Lib()
    monkeypatch.setattr(build, "load_library", lambda n: (lib, build.BuildInfo(Path(n), 0.0, "")))
    assert k1.KERNEL.load() is lib and k1.KERNEL.launch is lib.hygeia_optimal_resampling
    assert len(lib.hygeia_optimal_resampling.argtypes) == 12
    assert lib.hygeia_empty_launch.argtypes == [ctypes.c_void_p]
    assert lib.hygeia_cuda_error_string.restype is ctypes.c_char_p
