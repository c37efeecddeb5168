"""The benchmark of `gnnla_tpu_torch`, the PyTorch and CUDA port, on
NVIDIA cards.

One command runs one cell of `BENCHMARK.json` (see `run.py`). Everything
that belongs to one configuration, traffic mix or per-layer metric is a
file of its own, found by the name `BENCHMARK.json` gives it:

    configs/<config>.json    the deployment: problem, size, solver, tolerance
    problems/<problem>.py    the matrix of a kind of problem, from a config
    traffic/<traffic>.json   the mix's parameters; its "loop" names a driver
    drivers/<loop>.py        the closed loop that drives the port
    metrics/<metric>.py      a reader of one per-layer metric
    limits/<cell>.json       a cell's limits of `correct`, where the
                             configuration states none

The yardstick lives here too, frozen against changes to the port: the
matrix builders (`problems/`), the peaks and floor bytes (`roofline.py`),
the profiler reader (`trace.py`) and the plain reference that decides
`correct` (`reference/`). Nothing here imports JAX or the JAX package.
"""
