"""The theta.engine span (the online engine, synced) a call site, less the check's copies, ms."""

from perfbench.readers import ms_per_site

read = ms_per_site("theta_engine_s")
