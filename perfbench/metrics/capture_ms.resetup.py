"""Host ms a capture of the solve program for a new hierarchy: the stages
`program.warmup` (one eager solve on a side stream) and `program.capture`
(the CUDA-graph capture), over the captures, from the port's span
registry. None where no capture ran (on the CPU a program is its
function)."""


def read(run):
    from gnnla_tpu_torch.utils import program
    report = getattr(program, "report", None)
    if report is None:
        return None
    reg = report()
    warm, cap = reg.get("program.warmup"), reg.get("program.capture")
    if not warm or not cap or not cap["calls"]:
        return None
    return 1e3 * (warm["host_s"] + cap["host_s"]) / cap["calls"]
