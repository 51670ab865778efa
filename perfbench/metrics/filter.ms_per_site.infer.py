"""The runner's synced filter seconds (optimal_time_{s}.txt x units) a window site, ms."""

from perfbench.readers import ms_per_site

read = ms_per_site("filter_s")
