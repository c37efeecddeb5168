"""Host seconds of `stream_operator`'s set-up: its stages `stream.csr`
(the host CSR), `stream.rcm` (the ordering and its permutations) and
`stream.layout` (K2's CSR, its row blocks and the gathers' indices on
the device), from the port's span registry. None where one is missing."""

STAGES = ("stream.csr", "stream.rcm", "stream.layout")


def read(run):
    from gnnla_tpu_torch.utils import program
    report = getattr(program, "report", None)
    if report is None:
        return None
    reg = report()
    stages = [reg.get(name) for name in STAGES]
    if not all(s and s["calls"] for s in stages):
        return None
    return sum(s["host_s"] for s in stages)
