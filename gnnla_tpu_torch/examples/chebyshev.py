"""Chebyshev relaxation: GNN vs traditional recurrence over degrees
{1,2,3,4,8} (reference ChebyGNN.py:355-412, matlab/test_chebyshev.m)."""
import numpy as np
import torch

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.models import chebyshev, chebyshev_gnn
from gnnla_tpu_torch.problems import laplacian_2d


def cheby_traditional(A_sp, b, x, c, d, deg):
    """The classical recurrence (ChebyGNN.py run_ChebyTrad_Deg)."""
    b = np.asarray(b, np.float64)
    x = np.asarray(x, np.float64)
    r = b - A_sp @ x
    alpha = 1.0 / d
    p = r.copy()
    x = x + alpha * p
    for k in range(2, deg + 1):
        z = A_sp @ p
        r = r - alpha * z
        beta = 0.5 * (c * alpha) ** 2 if k == 2 else ((c * alpha) / 2.0) ** 2
        alpha = 1.0 / (d - beta / alpha)
        p = r + beta * p
        x = x + alpha * p
    return x


def main(n=25, seed=24601, c=-3.4, d=-4.0, device="cuda"):
    dev = resolve_device(device)
    A = laplacian_2d(n, device=dev)
    rng = np.random.default_rng(seed)
    b_h = rng.random(n * n).astype(np.float32)
    x0_h = rng.random(n * n).astype(np.float32)
    b, x0 = torch.from_numpy(b_h).to(dev), torch.from_numpy(x0_h).to(dev)
    A_sp = A.to_scipy()

    for deg in (1, 2, 3, 4, 8):
        x_fast = chebyshev(A, b, x0, c=c, d=d, deg=deg).cpu().numpy()
        x_gnn = chebyshev_gnn(A, b, x0, c=c, d=d, deg=deg).cpu().numpy()
        x_ref = cheby_traditional(A_sp, b_h, x0_h, c, d, deg)
        err = np.linalg.norm(x_fast - x_ref) / np.linalg.norm(x_ref)
        err_g = np.linalg.norm(x_gnn - x_ref) / np.linalg.norm(x_ref)
        print(f"deg {deg}: fast rel err {err:.3e}, gnn rel err {err_g:.3e}")
        assert err < 1e-4 and err_g < 1e-4


if __name__ == "__main__":
    main()
