"""y = A x, the residual of a solve, and conjugate gradients, in plain
PyTorch on the COO the harness built (gather, multiply, scatter-add).

The reference judges the program's outputs in float64. Given a lower
dtype, the same code is the control: the reference put in the program's
place at a precision below the configuration's float32, which the
comparison has to refuse.
"""

from __future__ import annotations

import numpy as np
import torch


class Reference:
    """A (n x n, from row-sorted COO triplets) on `device` in `dtype`."""

    def __init__(self, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 n: int, device, dtype=torch.float64):
        self.n = int(n)
        self.dtype = dtype
        self.device = torch.device(device)
        self.rows = torch.from_numpy(np.asarray(rows, np.int64)).to(device)
        self.cols = torch.from_numpy(np.asarray(cols, np.int64)).to(device)
        self.vals = torch.from_numpy(np.asarray(vals, np.float64)).to(
            device=device, dtype=dtype)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A x in the reference's dtype."""
        x = x.to(device=self.device, dtype=self.dtype).reshape(-1)
        prod = x.index_select(0, self.cols) * self.vals
        return torch.zeros(self.n, device=self.device,
                           dtype=self.dtype).index_add_(0, self.rows, prod)

    def rel_residual(self, b: torch.Tensor, x: torch.Tensor) -> float:
        """||b - A x|| / ||b|| (2-norms), b and x taken as they are."""
        b = b.to(device=self.device, dtype=self.dtype).reshape(-1)
        r = b - self.matvec(x)
        nb = float(torch.linalg.vector_norm(b.double()))
        return float(torch.linalg.vector_norm(r.double())) / max(nb, 1e-300)

    def cg(self, b: torch.Tensor, *, tol: float, max_iters: int):
        """Unpreconditioned CG from zero in the reference's dtype, until
        the recurrence residual is under tol * ||b|| or max_iters.
        Returns (x, iterations)."""
        dot = (lambda u, v: (u * v).sum())
        b = b.to(device=self.device, dtype=self.dtype).reshape(-1)
        x = torch.zeros_like(b)
        r = b.clone()
        p = r.clone()
        rr = dot(r, r)
        stop = (tol * torch.linalg.vector_norm(b.double())) ** 2
        it = 0
        while it < max_iters and float(rr) > float(stop):
            ap = self.matvec(p)
            alpha = rr / dot(p, ap)
            x = x + alpha * p
            r = r - alpha * ap
            rr_new = dot(r, r)
            p = r + (rr_new / rr) * p
            rr = rr_new
            it += 1
        return x, it
