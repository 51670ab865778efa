"""K1's byte bound at 3.35 TB/s over its device time a launch in the traced stretches, %."""

from perfbench.readers import k1_roofline_pct

read = k1_roofline_pct
