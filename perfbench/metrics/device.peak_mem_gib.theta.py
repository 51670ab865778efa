"""torch.cuda.max_memory_allocated over the window, GiB."""

from perfbench.readers import peak_mem_gib

read = peak_mem_gib
