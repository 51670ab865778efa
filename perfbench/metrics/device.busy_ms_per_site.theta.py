"""Device-busy milliseconds a traced steady engine site."""

from perfbench.readers import busy_ms_per_site

read = busy_ms_per_site
