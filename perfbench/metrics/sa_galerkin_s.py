"""Host seconds of the Galerkin products P^T A P of the SA set-up, all
levels: the stage `sa.galerkin` of `setup_sa_multigrid`, from the port's
span registry."""


def read(run):
    from gnnla_tpu_torch.utils import program
    report = getattr(program, "report", None)
    if report is None:
        return None
    galerkin = report().get("sa.galerkin")
    if not galerkin or not galerkin["calls"]:
        return None
    return galerkin["host_s"]
