"""Residual + matrix-weighted norm vs formulas (reference
GNNResidual.py:135-171, MatrixWeightedNorm.py:165-210)."""
import numpy as np
import torch

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.models import matrix_weighted_norm, residual
from gnnla_tpu_torch.problems import laplacian_2d


def main(n=25, seed=24601, device="cuda"):
    dev = resolve_device(device)
    A = laplacian_2d(n, device=dev)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random(n * n).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.random(n * n).astype(np.float32)).to(dev)
    x64, b64 = x.double().cpu().numpy(), b.double().cpu().numpy()

    r = residual(A, b, x)
    r_ref = b64 - A.to_scipy() @ x64
    err = np.linalg.norm(r.cpu().numpy() - r_ref) / np.linalg.norm(r_ref)
    print(f"residual rel error: {err:.3e}")

    # -A is SPD (Laplacian here is negative definite)
    W = A.scale(-1.0)
    g = float(matrix_weighted_norm(W, x))
    g_ref = float(np.sqrt(x64 @ (W.to_scipy() @ x64)))
    print(f"weighted norm: gnn {g:.6f} vs formula {g_ref:.6f}")
    assert abs(g - g_ref) < 1e-3


if __name__ == "__main__":
    main()
