"""Unit-sites of the window's INFER calls (window sites x units) over their wall."""

from perfbench.readers import rate

read = rate("unit_sites")
