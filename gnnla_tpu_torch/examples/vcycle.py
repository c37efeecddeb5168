"""Two-grid AMG V-cycle: residual per cycle vs plain Jacobi
(reference VCycle.py:239-277, matlab/test_vcycle.m). The DIA levels run
their plain form (kernel=False), as the JAX example keeps `pallas` off."""
import numpy as np
import torch

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.models import (jacobi, residual, setup_twogrid,
                                    setup_with_dia, solve, vcycle)
from gnnla_tpu_torch.problems import laplacian_2d


def main(n=25, seed=24601, n_cycles=5, device="cuda"):
    dev = resolve_device(device)
    A = laplacian_2d(n, device=dev)
    rng = np.random.default_rng(seed)
    b = torch.from_numpy(rng.random(n * n).astype(np.float32)).to(dev)
    x = torch.zeros(n * n, device=dev)

    setup = setup_with_dia(setup_twogrid(A, theta=0.25, splitting="cljp"))
    print(f"coarse points: {int(setup.coarse_flags.sum())}/{A.n_rows}")

    def norm(v):
        return float(torch.linalg.vector_norm(v))

    for k in range(n_cycles):
        x = vcycle(setup, b, x, n_pre=3, n_post=3, coarse_deg=4)
        print(f"cycle {k + 1}: |r| = {norm(residual(A, b, x)):.4e}")

    x_jac = jacobi(A, b, torch.zeros(n * n, device=dev), omega=0.7,
                   n_iters=6 * n_cycles)
    print(f"plain Jacobi ({6 * n_cycles} sweeps): |r| = "
          f"{norm(residual(A, b, x_jac)):.4e}")

    x_scan = solve(setup, b, torch.zeros(n * n, device=dev),
                   n_cycles=n_cycles, n_pre=3, n_post=3, coarse_deg=4)
    print(f"scanned solve matches loop: {norm(x_scan - x):.3e}")


if __name__ == "__main__":
    main()
