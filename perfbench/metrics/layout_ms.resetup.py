"""Host ms a set-up of the solve's kernel layouts: the stages `dia.layout`
(K1's layout of each level `to_dia` takes) and `k2.layout` (K2's CSRs of
the other levels and of every P) of `setup_with_dia_multigrid`, over the
SA set-ups (`sa.coarse_interval`, once each), from the port's span
registry. None where a stage is missing."""

STAGES = ("dia.layout", "k2.layout")


def read(run):
    from gnnla_tpu_torch.utils import program
    report = getattr(program, "report", None)
    if report is None:
        return None
    reg = report()
    setups = reg.get("sa.coarse_interval")
    stages = [reg.get(name) for name in STAGES]
    if not setups or not setups["calls"] or \
            not all(s and s["calls"] for s in stages):
        return None
    return 1e3 * sum(s["host_s"] for s in stages) / setups["calls"]
