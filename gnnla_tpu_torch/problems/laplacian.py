"""Finite-difference Laplacians — the counterpart of
gnnla_tpu/problems/laplacian.py.

  * `laplacian_2d(N)` — the 2D 5-point Laplacian by Kronecker sums,
    reference sign convention (diagonal -4, off-diagonals +1).
  * `laplacian_nd(npts, bcs)` — N-dimensional FD Laplacian with optional
    periodic wrap per dimension, positive-definite convention (diagonal
    +2*ndim, off-diagonals -1), with the grid's vertices and Dirichlet
    neighbour counts.
  * `grid_coords_2d(n)` — unit-square interior coordinates of an n x n grid.

Assembly is host-side numpy/scipy, identical to the JAX package's.
"""

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


def laplacian_nd(npts, bcs=None, *, dtype=torch.float32, device="cuda"):
    """N-dimensional FD Laplacian, positive-definite convention
    (diag +2*ndim, off-diag -1), optional periodic BC per dimension
    (bcs[d] == 1).

    Returns (op, vertices, dirichlet_neighbors):
      vertices : [N, ndim] integer grid coordinates (1-based)
      dn       : [N] count of eliminated Dirichlet neighbours per vertex
    """
    npts = list(npts)
    ndim = len(npts)
    if bcs is None:
        bcs = [0] * ndim
    n = int(np.prod(npts))

    mat = 2 * ndim * sp.eye(n, format="lil")
    jump = np.concatenate([[1], np.cumprod(npts)])
    for d in range(ndim):
        j = int(jump[d])
        block = int(jump[d + 1])
        # interior neighbour mask along dimension d
        vec = np.tile(np.concatenate([np.ones(j * (npts[d] - 1)),
                                      np.zeros(j)]), n // block)[: n - j]
        mat = mat - sp.diags(vec, offsets=j, shape=(n, n)) \
                  - sp.diags(vec, offsets=-j, shape=(n, n))
        if bcs[d] == 1:  # periodic wrap
            jp = block - j
            vec_p = np.tile(np.concatenate([np.ones(j),
                                            np.zeros(j * (npts[d] - 1))]),
                            n // block)[: n - jp]
            mat = mat - sp.diags(vec_p, offsets=jp, shape=(n, n)) \
                      - sp.diags(vec_p, offsets=-jp, shape=(n, n))

    mat = mat.tocoo()
    vertices = np.arange(1, npts[0] + 1).reshape(-1, 1)
    for d in range(1, ndim):
        sz = vertices.shape[0]
        rep = np.tile(vertices, (npts[d], 1))
        new_col = np.repeat(np.arange(1, npts[d] + 1), sz).reshape(-1, 1)
        vertices = np.hstack([rep, new_col])

    deg = np.asarray((np.abs(mat) > 0).sum(axis=1)).ravel()
    dn = deg.max() - deg
    op = SparseOperator.from_scipy(mat, dtype=dtype, device=device)
    return op, vertices, dn


def grid_coords_2d(n: int) -> np.ndarray:
    """Unit-square interior coordinates of the n x n grid vertices (the
    reference's high-frequency-mode coordinates): x_i = (i+1)/(n+1)."""
    idx = np.arange(n)
    x = (idx + 1) / (n + 1)
    xx, yy = np.meshgrid(x, x, indexing="xy")
    return np.stack([xx.ravel(), yy.ravel()], axis=1)
