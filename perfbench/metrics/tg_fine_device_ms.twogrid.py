"""Device ms a two-grid solve on the fine grid: the spans `tg.pre`,
`tg.residual` and `tg.post` (the three K4 calls of each cycle and the
smoother's right-hand side), over the traced cycles, times n_cycles."""

from perfbench.twogrid_spans import device_ms_per_solve


def read(run):
    return device_ms_per_solve(run, ("tg.pre", "tg.residual", "tg.post"))
