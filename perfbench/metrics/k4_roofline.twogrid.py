"""K4's share of its roofline in the two-grid solves: each K4 call's
launches in the traced segment (the port's exact counters: the cycle's
Jacobi and residual calls and each solve's residual check) times the
call's floor bytes, over the device time of the `stencil` kernels at the
HBM rate."""

from perfbench import roofline

STENCIL = ("stencil",)


def floor_bytes(call: dict) -> int:
    """Least bytes of one K4 launch: the taps as stored, x read once and
    written once, and in the affine mode its right-hand side (b, or the
    smoother's omega b / d) read once, 4 B a point each."""
    n = call["n"]
    vectors = 2 + (call["mode"] == "affine")
    return call["K"] * n * call["tap_bytes"] + vectors * n * roofline.F32


def read(run):
    t = run.trace
    calls = run.info.get("k4_calls")
    if t is None or not calls:
        return None
    counts = run.segment.get("counters", {})
    floor = sum(counts.get(c["counter"], 0) * floor_bytes(c) for c in calls)
    return roofline.share_pct(roofline.floor_seconds(floor),
                              t.seconds_matching(STENCIL))
