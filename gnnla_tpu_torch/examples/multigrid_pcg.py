"""Multilevel AMG + AMG-preconditioned CG (capability beyond the
reference's two-grid cycle; see models/multigrid.py, models/krylov.py)."""
import numpy as np
import torch

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.models import (amg_pcg, cg, mg_pcg, multigrid_cycle,
                                    residual, setup_multigrid,
                                    setup_sa_multigrid, setup_twogrid)
from gnnla_tpu_torch.problems import laplacian_2d


def main(n=32, seed=24601, device="cuda"):
    dev = resolve_device(device)
    A = laplacian_2d(n, device=dev)
    N = n * n
    rng = np.random.default_rng(seed)
    b = torch.from_numpy(rng.random(N).astype(np.float32)).to(dev)
    x0 = torch.zeros(N, device=dev)

    def rnorm(x):
        return float(torch.linalg.vector_norm(residual(A, b, x)))

    mg = setup_multigrid(A, min_coarse=16)
    print(f"hierarchy sizes: {[op.n_rows for op in mg.As]}")
    x = x0
    for k in range(5):
        x = multigrid_cycle(mg, b, x, n_pre=2, n_post=2)
        print(f"multigrid cycle {k + 1}: |r| = {rnorm(x):.3e}")

    tg = setup_twogrid(A, theta=0.25, splitting="cljp")
    _, hist_cg = cg(lambda v: -A.matvec(v), -b, x0, n_iters=30)
    x_pcg, hist_pcg = amg_pcg(tg, b, x0, n_iters=15, flip_sign=True)
    print(f"plain CG 30 iters:  |r| = {float(hist_cg[-1]):.3e}")
    print(f"AMG-PCG 15 iters:   |r| = {rnorm(x_pcg):.3e}")

    # smoothed-aggregation hierarchy: the size-independent production path
    sa = setup_sa_multigrid(A)
    print(f"SA hierarchy sizes: {[op.n_rows for op in sa.As]}")
    x_sa, _ = mg_pcg(sa, b, x0, n_iters=15, flip_sign=True)
    print(f"SA mg-PCG 15 iters: |r| = {rnorm(x_sa):.3e}")


if __name__ == "__main__":
    main()
