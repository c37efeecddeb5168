"""The card's idle share of the traced segment of items: 1 - device busy
(the union of its kernels' intervals) / the segment's seconds. The host's
set-up of each item's hierarchy leaves the card idle most of the time."""

from perfbench.readers import idle_pct


def read(run):
    return idle_pct(run)
