"""What the two-grid cell's span readers share: device ms a solve of a
set of the port's `tg.*` spans, from its span registry
(`gnnla_tpu_torch/utils/program.py::report`). A solve is the
configuration's n_cycles cycles, each one `tg.cycle` span, so a figure
is the spans' device seconds over the traced cycles, times n_cycles."""

from __future__ import annotations

SETUP_STAGES = ("tg.strength", "tg.split", "tg.interp", "tg.galerkin",
                "tg.taps", "tg.layout")


def spans():
    """The port's span registry, or None where the port has none."""
    from gnnla_tpu_torch.utils import program
    report = getattr(program, "report", None)
    return None if report is None else report()


def device_ms_per_solve(run, names):
    """Device ms a solve of the spans `names` (inclusive times), or None
    where a span or the traced cycles are missing."""
    reg = spans()
    if reg is None:
        return None
    cycle = reg.get("tg.cycle")
    parts = [reg.get(n) for n in names]
    if not cycle or not cycle["device_calls"] or \
            not all(p and p["device_calls"] for p in parts):
        return None
    n_cycles = int(run.config["twogrid"]["n_cycles"])
    return 1e3 * n_cycles * sum(p["device_s"] for p in parts) / \
        cycle["device_calls"]


def setup_s():
    """Host seconds of the six stages of the classical set-up and the
    stencil cycle's layouts, or None where one is missing."""
    reg = spans()
    if reg is None:
        return None
    stages = [reg.get(n) for n in SETUP_STAGES]
    if not all(s and s["calls"] for s in stages):
        return None
    return sum(s["host_s"] for s in stages)
