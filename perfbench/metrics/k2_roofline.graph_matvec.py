"""K2's share of its roofline in the graph applies: its launches (the
port's exact counter, `CsrSpMV.launches` of the operator's CSR) times
the floor bytes of one apply (stored values, x and y once) over the
device time of K2's kernels (`csr_spmv_blocks`) at the HBM rate."""

from perfbench import roofline

K2 = ("csr_spmv",)


def read(run):
    t = run.trace
    launches = run.segment.get("counters", {}).get("k2_graph")
    levels = run.info.get("levels")
    if t is None or not launches or not levels:
        return None
    floor = launches * roofline.spmv_floor_bytes(levels[0]["nnz"],
                                                 levels[0]["n"])
    return roofline.share_pct(roofline.floor_seconds(floor),
                              t.seconds_matching(K2))
