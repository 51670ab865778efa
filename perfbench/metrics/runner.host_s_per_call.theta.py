"""A call's wall minus its theta.engine span: reads, tables, writes and the fetch."""

from perfbench.readers import host_s_per_call

read = host_s_per_call("theta_engine_s")
