"""Power method lambda_max vs classical iteration
(reference PowerMethodGNN.py:336-383, matlab/test_power_method.m)."""
import numpy as np
import torch

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.models import power_method, power_method_gnn
from gnnla_tpu_torch.problems import laplacian_2d


def main(n=25, seed=24601, n_iters=30, device="cuda"):
    dev = resolve_device(device)
    A = laplacian_2d(n, device=dev)
    rng = np.random.default_rng(seed)
    b0_h = rng.random(n * n).astype(np.float32)
    b0 = torch.from_numpy(b0_h).to(dev)

    lam, _ = power_method(A, b0, n_iters=n_iters)
    lam_gnn, _ = power_method_gnn(A, b0, n_iters=n_iters)

    # classical reference iteration in float64
    A_sp = A.to_scipy()
    b = b0_h.astype(np.float64)
    for _ in range(n_iters):
        ab = A_sp @ b
        b = ab / np.linalg.norm(ab)
    lam_ref = (b @ (A_sp @ b)) / (b @ b)

    print(f"lambda_max: fast {float(lam):.6f}, gnn {float(lam_gnn):.6f}, "
          f"classical {lam_ref:.6f}")
    assert abs(float(lam) - lam_ref) / abs(lam_ref) < 1e-3


if __name__ == "__main__":
    main()
