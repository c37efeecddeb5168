"""Device ms a solve of the COO operators (every P and P^T, and the
levels `to_dia` refused): PyTorch's gather, index and scatter-add kernels
in the traced segment, over the segment's solves."""

from perfbench.readers import COO, PORT_KERNELS


def read(run):
    if run.trace is None or not run.segment.get("items"):
        return None
    s = run.trace.seconds_matching(COO, exclude=PORT_KERNELS)
    return 1e3 * s / run.segment["items"] if s > 0 else None
