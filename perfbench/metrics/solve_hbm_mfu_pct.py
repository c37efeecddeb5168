"""The whole solve's share of the card's peak: a floor of pcg_iters x 4
applies of the input matrix (CG's matvec, the V(1,1) cycle's pre-sweep,
residual and post-sweep on the finest level), each its stored f32 values,
x and y once, over the mean solve time of the window at the HBM rate.
Counted from the input matrix, so it reads the same work whatever
implements it."""

from perfbench import roofline


def read(run):
    iters, mean_s = run.info.get("pcg_iters"), run.window.get("solve_s_mean")
    if not iters or not mean_s or run.problem is None:
        return None
    rows, _, _, n = run.problem
    floor = iters * 4 * roofline.spmv_floor_bytes(int(rows.shape[0]), n)
    return roofline.share_pct(roofline.floor_seconds(floor), mean_s)
