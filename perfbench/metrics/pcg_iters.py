"""The iterations every timed solve runs: the largest count at which the
port's residual history fell under tol * ||b|| in the warm-up, plus one."""


def read(run):
    return run.info.get("pcg_iters")
