"""Weighted Jacobi: single-sweep parity + 100-sweep residual convergence
(reference JacobiGNN.py:150-201, matlab/test_jacobi.m)."""
import numpy as np
import torch

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.models import jacobi, jacobi_gnn, residual
from gnnla_tpu_torch.problems import laplacian_2d


def main(n=5, seed=24601, omega=2.0 / 3.0, device="cuda"):
    dev = resolve_device(device)
    A = laplacian_2d(n, device=dev)
    rng = np.random.default_rng(seed)
    b = torch.from_numpy(rng.random(n * n).astype(np.float32)).to(dev)
    x0 = torch.from_numpy(rng.random(n * n).astype(np.float32)).to(dev)

    # single-sweep parity vs the formula x + w D^-1 (b - A x)
    x1 = jacobi(A, b, x0, omega=omega, n_iters=1)
    d = A.host_diagonal()
    x0_64 = x0.double().cpu().numpy()
    x_ref = x0_64 + omega / d * (b.double().cpu().numpy()
                                 - A.to_scipy() @ x0_64)
    err = np.linalg.norm(x1.cpu().numpy() - x_ref) / np.linalg.norm(x_ref)
    print(f"1-sweep rel error: {err:.3e}")
    x1g = jacobi_gnn(A, b, x0, omega=omega, n_iters=1)
    np.testing.assert_allclose(x1g.cpu().numpy(), x1.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)

    # 100-sweep residual decrease, printed every 10 (JacobiGNN.py:190-201)
    x = x0
    for k in range(1, 11):
        x = jacobi(A, b, x, omega=omega, n_iters=10)
        print(f"after {10 * k:3d} sweeps: |r| = "
              f"{float(torch.linalg.vector_norm(residual(A, b, x))):.4e}")


if __name__ == "__main__":
    main()
