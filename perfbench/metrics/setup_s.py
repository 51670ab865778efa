"""Set-up seconds: imports, the CUDA context, the inputs, the kernel's build or load, the warm-up."""

from perfbench.readers import setup_s

read = setup_s
