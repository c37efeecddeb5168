"""The whole apply loop's share of the card's peak: applies of the window
times the floor bytes of one (stored f32 values, x and y once), over the
window's seconds at the HBM rate of every card the cell uses."""

from perfbench import roofline


def read(run):
    applies, secs = run.window.get("items_attempted"), run.window.get(
        "seconds")
    if not applies or not secs or run.problem is None:
        return None
    rows, _, _, n = run.problem
    floor = applies * roofline.spmv_floor_bytes(int(rows.shape[0]), n)
    return roofline.share_pct(roofline.floor_seconds(floor),
                              secs * run.cell.chips)
