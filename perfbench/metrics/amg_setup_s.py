"""Seconds of the port's host set-up of the hierarchy: the harness clock
around `setup_sa_multigrid` and `setup_with_dia_multigrid(kernel=True)`."""


def read(run):
    return run.info.get("amg_setup_s")
