"""Finite-difference Laplacians — the counterpart of
gnnla_tpu/problems/laplacian.py (`laplacian_2d` only in this slice)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from gnnla_tpu_torch.ops.sparse import SparseOperator


def laplacian_2d(n: int, *, dtype=torch.float32,
                 device="cuda") -> SparseOperator:
    """2D 5-point Laplacian on an n x n grid, reference sign convention
    (diag -4, off-diag +1), assembled by the same scipy Kronecker sum.
    Shape [n^2, n^2]. Like the JAX fixture it keeps the explicit zeros
    the Kronecker product emits; call `eliminate_zeros()` for the tight
    pattern."""
    eye = sp.eye(n)
    ones = np.ones(n)
    lap1d = sp.spdiags([ones, -2 * ones, ones], [-1, 0, 1], n, n)
    lap2d = sp.kron(eye, lap1d) + sp.kron(lap1d, eye)
    return SparseOperator.from_scipy(lap2d.tocoo(), dtype=dtype,
                                     device=device)
