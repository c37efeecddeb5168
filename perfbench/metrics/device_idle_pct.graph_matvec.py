"""The card's idle share of the traced segment of graph applies: 1 -
device busy (the union of its kernels' intervals) / the segment's
seconds."""

from perfbench.readers import idle_pct


def read(run):
    return idle_pct(run)
