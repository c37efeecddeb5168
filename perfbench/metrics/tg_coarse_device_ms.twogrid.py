"""Device ms a two-grid solve in the coarse solve: the span `tg.coarse`
(the degree-4 Chebyshev on Ac, its applies on K1), over the traced
cycles, times n_cycles."""

from perfbench.twogrid_spans import device_ms_per_solve


def read(run):
    return device_ms_per_solve(run, ("tg.coarse",))
