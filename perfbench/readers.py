"""What the per-layer metrics share: the kernels' names as the traced run
prints them, and the arithmetic of a kernel's share of its roofline.

K1 launches `dia_tiles_kernel` or `dia_tiles_split_kernel`
(`gnnla_tpu_torch/csrc/dia_spmv.cu`). The COO operators run PyTorch's
own gather, index and scatter-add kernels. A program's replay is one
`cudaGraphLaunch` on the host."""

from __future__ import annotations

from perfbench import roofline

K1 = ("dia_tiles",)
COO = ("index", "gather", "scatter")
GRAPH_LAUNCH = "cudaGraphLaunch"
PORT_KERNELS = ("dia_tiles", "csr_spmv", "csr_spmm", "stencil", "ellw")


def idle_pct(run):
    """The device's idle share of the traced segment, in percent: 1 - its
    busy seconds (the union of its kernels' intervals) / the segment's
    seconds, both from the one trace. The profiler slows the host's
    launches, so this reads higher than the untraced window would."""
    t = run.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def launch_gap_ms(run):
    """Device-idle ms an item while the host is inside `cudaGraphLaunch`
    (the idle gaps the trace labels with it), over the traced segment's
    items; None when the segment launched no graph."""
    t, seg = run.trace, run.segment
    if t is None or not seg.get("items") or \
            not t.host_calls.get(GRAPH_LAUNCH):
        return None
    gap = sum(s for label, s in t.idle.items()
              if label.split(" > ")[-1] == GRAPH_LAUNCH)
    return 1e3 * gap / seg["items"]


def k1_roofline_pct(run):
    """K1's share of its roofline over the traced segment: each level's
    launches (the port's exact counters) times that level's floor bytes,
    over K1's device time at the HBM rate."""
    t = run.trace
    if t is None:
        return None
    k1_s = t.seconds_matching(K1)
    counts = run.segment.get("counters", {})
    floor = 0.0
    for lvl, level in enumerate(run.info.get("levels", [])):
        launches = counts.get(f"k1_level_{lvl}", 0)
        floor += launches * roofline.spmv_floor_bytes(level["nnz"],
                                                      level["n"])
    return roofline.share_pct(roofline.floor_seconds(floor), k1_s)
