"""Host seconds of the two-grid set-up's stages: `tg.strength`,
`tg.split`, `tg.interp`, `tg.galerkin` (`setup_twogrid`) and `tg.taps`,
`tg.layout` (`StencilVCycle`'s K4 taps and coarse layouts), from the
port's span registry."""

from perfbench.twogrid_spans import setup_s


def read(run):
    return setup_s()
