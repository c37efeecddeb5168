"""Host seconds a capture of the two-grid cycle's program: the stages
`program.warmup` (one eager cycle on a side stream) and `program.capture`
(the CUDA-graph capture), over the run's captures (set-up's, and the
instrumented graph's in the traced run), from the port's span
registry."""


def read(run):
    from gnnla_tpu_torch.utils import program
    report = getattr(program, "report", None)
    if report is None:
        return None
    spans = report()
    warm, cap = spans.get("program.warmup"), spans.get("program.capture")
    if not warm or not cap or not cap["calls"]:
        return None
    return (warm["host_s"] + cap["host_s"]) / cap["calls"]
