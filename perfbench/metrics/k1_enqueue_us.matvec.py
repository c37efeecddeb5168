"""Host us an apply in K1's enqueue: the span `k1.launch` of
`DiaKernelOperator.launch` (the layout's key check, the guard, the
counter, the wrapper and `cudaLaunchKernel`), its mean a call over the
traced applies, from the port's span registry."""


def read(run):
    from gnnla_tpu_torch.utils import program
    report = getattr(program, "report", None)
    if report is None:
        return None
    launch = report().get("k1.launch")
    if not launch or not launch["calls"]:
        return None
    return 1e6 * launch["host_s"] / launch["calls"]
