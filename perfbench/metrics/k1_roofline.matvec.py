"""K1's share of its roofline in the applies: its launches
times the floor bytes (stored values, x and y once) over K1's device
time at the HBM rate."""

from perfbench.readers import k1_roofline_pct


def read(run):
    return k1_roofline_pct(run)
