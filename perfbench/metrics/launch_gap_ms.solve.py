"""Device-idle ms a solve while the host is inside `cudaGraphLaunch`,
the replay of the solve's captured program, in the traced segment. A
solve's time is bimodal by this gap, and the mode holds for a whole
process, so a change of `solve_ms_p95` that this moves with is the
launch's and not the device's work."""

from perfbench.readers import launch_gap_ms


def read(run):
    return launch_gap_ms(run)
