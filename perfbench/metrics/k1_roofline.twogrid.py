"""K1's share of its roofline in the two-grid solves: Ac's launches times
its floor bytes (stored values, x and y once) over K1's device time at
the HBM rate."""

from perfbench.readers import k1_roofline_pct


def read(run):
    return k1_roofline_pct(run)
