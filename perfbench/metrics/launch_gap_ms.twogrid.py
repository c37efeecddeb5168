"""Device-idle ms a two-grid solve while the host is inside
`cudaGraphLaunch`, the replay of one captured cycle (five a solve), in the
traced segment: how far the host's launches hold the card back."""

from perfbench.readers import launch_gap_ms


def read(run):
    return launch_gap_ms(run)
