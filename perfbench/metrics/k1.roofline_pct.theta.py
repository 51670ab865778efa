"""K1's byte bound at 3.35 TB/s (N=250, M=244, one unit) over its device time a launch in the traced stretches, %."""

from perfbench.readers import k1_roofline_pct

read = k1_roofline_pct
