"""Host us an apply in K2's enqueue: the span `k2.launch` of
`CsrSpMV.launch` (the wrapper's checks, the counters and the kernel's
launch), its mean a call over the traced applies, from the port's span
registry."""


def read(run):
    from gnnla_tpu_torch.utils import program
    report = getattr(program, "report", None)
    if report is None:
        return None
    launch = report().get("k2.launch")
    if not launch or not launch["calls"]:
        return None
    return 1e6 * launch["host_s"] / launch["calls"]
