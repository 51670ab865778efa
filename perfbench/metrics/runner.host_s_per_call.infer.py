"""A call's wall minus its filter and backward seconds: reads, tables, functionals, writes."""

from perfbench.readers import host_s_per_call

read = host_s_per_call("filter_s", "backward_s")
