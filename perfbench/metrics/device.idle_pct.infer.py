"""Share of the traced stretches with no device operation running, %."""

from perfbench.readers import idle_pct

read = idle_pct
