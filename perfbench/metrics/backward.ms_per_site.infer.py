"""The runner's synced backward seconds (optimal_time_backward_{s}.txt x units) a window site, ms."""

from perfbench.readers import ms_per_site

read = ms_per_site("backward_s")
