"""Device-busy milliseconds a traced loop site, the filter's and the backward
pass's together."""

from perfbench.readers import busy_ms_per_site

read = busy_ms_per_site
