"""Host ms a two-grid solve in the cycle program's own bookkeeping around
its launches: the spans `program.lookup` (cache key, graph, guards),
`program.inputs` (copies into the graph's buffers) and `program.outputs`
(counters, the output's clone), each its mean a call, times the
configuration's n_cycles (one program call a cycle), from the port's
span registry."""

SPANS = ("program.lookup", "program.inputs", "program.outputs")


def read(run):
    from gnnla_tpu_torch.utils import program
    report = getattr(program, "report", None)
    if report is None:
        return None
    spans = report()
    if not all(spans.get(name, {}).get("calls") for name in SPANS):
        return None
    n_cycles = int(run.config["twogrid"]["n_cycles"])
    return 1e3 * n_cycles * sum(spans[name]["host_s"] / spans[name]["calls"]
                                for name in SPANS)
