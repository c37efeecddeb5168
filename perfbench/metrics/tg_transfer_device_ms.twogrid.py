"""Device ms a two-grid solve in the grid transfers: the spans
`tg.restrict` (P^T r) and `tg.prolong` (x + P xc), on K2 where P is, over
the traced cycles, times n_cycles."""

from perfbench.twogrid_spans import device_ms_per_solve


def read(run):
    return device_ms_per_solve(run, ("tg.restrict", "tg.prolong"))
