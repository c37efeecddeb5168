"""Host ms a set-up of the SA hierarchy: the stages `sa.to_host`,
`sa.strength`, `sa.aggregate`, `sa.prolongator`, `sa.galerkin`,
`sa.to_device` and `sa.coarse_interval` of `setup_sa_multigrid`, over its
set-ups (`sa.coarse_interval` runs once a set-up; the other stages once a
level), from the port's span registry. None where a stage is missing."""

STAGES = ("sa.to_host", "sa.strength", "sa.aggregate", "sa.prolongator",
          "sa.galerkin", "sa.to_device", "sa.coarse_interval")


def read(run):
    from gnnla_tpu_torch.utils import program
    report = getattr(program, "report", None)
    if report is None:
        return None
    reg = report()
    stages = [reg.get(name) for name in STAGES]
    if not all(s and s["calls"] for s in stages):
        return None
    return 1e3 * sum(s["host_s"] for s in stages) / stages[-1]["calls"]
