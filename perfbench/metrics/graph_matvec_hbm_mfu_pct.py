"""The whole graph apply loop's share of the card's peak: the rule of
`matvec_hbm_mfu_pct` (applies of the window times the floor bytes of one,
stored f32 values, x and y once, over the window's seconds at the HBM
rate), the same work whatever layout, reordering or gathers implement
it."""

import os

from perfbench.harness import load_module

_MATVEC = load_module(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "matvec_hbm_mfu_pct.py"), "perfbench_graph_mfu_rule")


def read(run):
    return _MATVEC.read(run)
