"""Device us an apply in the caller-order gathers (`StreamOperator.
_apply`'s x into K2's order and y back, each a `stream.perm` span): the
device time of PyTorch's index and gather kernels in the traced segment
over its applies (K2's launches, the port's exact counter). Read from the
kernels and not from the spans' own events: an eager span's events also
time the device idling while the profiled host enqueues."""

GATHERS = ("index", "gather")


def read(run):
    t = run.trace
    applies = run.segment.get("counters", {}).get("k2_graph")
    if t is None or not applies:
        return None
    s = t.seconds_matching(GATHERS, exclude=("csr_spmv",))
    return 1e6 * s / applies if s > 0 else None
