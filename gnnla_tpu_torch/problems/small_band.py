"""Small-band FEM meshes: poorly scaled diagonals for the learned Jacobi
smoother — the counterpart of gnnla_tpu/problems/small_band.py.

A structured unit-square grid with a 2-element-wide vertical band of width
h inserted at the grid point nearest `band_loc`, homogeneous Dirichlet
boundaries eliminated (the reference's
TrainableJacobiDiag/getSmallBandMatrices.py:46-125). The thin elements
give large diagonal entries: the regime where a learned Jacobi diagonal
beats a fixed omega.

Returns (K, xy coords of the kept vertices, the snapped band location).
"""

from __future__ import annotations

import numpy as np
import torch

from gnnla_tpu_torch.ops.sparse import SparseOperator
from gnnla_tpu_torch.problems.quad_fem import build_matrix_quads


def small_band_matrix(n: int, h: float, band_loc: float = 0.5, *,
                      dtype=torch.float32, device="cuda"):
    """n = vertices per side of the base grid; h = band half-grid width.
    K is a SparseOperator on `device`."""
    K, xy, bl = small_band_matrix_host(n, h, band_loc)
    return SparseOperator.from_scipy(K, dtype=dtype, device=device), xy, bl


def small_band_matrix_host(n: int, h: float, band_loc: float = 0.5):
    """Host twin of `small_band_matrix` returning (scipy COO, xy,
    band_loc); touches no device, so dataset workers can run it."""
    x_grid = np.linspace(0.0, 1.0, n)
    band_idx = int(np.abs(x_grid - band_loc).argmin())
    x_band_loc = x_grid[band_idx]

    x_cols = np.concatenate([x_grid[:band_idx],
                             [x_band_loc - h, x_band_loc, x_band_loc + h],
                             x_grid[band_idx + 1:]])   # n+2 columns
    ncols = n + 2

    x = np.tile(x_cols, n)
    y = np.repeat(np.linspace(0.0, 1.0, n), ncols)
    xy = np.stack([x, y], axis=1)

    j, i = np.meshgrid(np.arange(n - 1), np.arange(ncols - 1),
                       indexing="ij")
    idx = (i + ncols * j).ravel()
    quads = np.stack([idx, idx + 1, idx + ncols + 1, idx + ncols], axis=1)

    K = build_matrix_quads(quads, xy).tocsr()

    # eliminate the homogeneous Dirichlet boundary: the first and last
    # grid rows and columns 0 and ncols-1 of every row
    pts = np.arange(n * ncols)
    on_boundary = ((pts < ncols) | (pts % ncols == 0)
                   | (pts % ncols == ncols - 1) | (pts >= ncols * (n - 1)))
    keep = pts[~on_boundary]
    K = K[keep][:, keep]
    K.sort_indices()
    return K.tocoo(), xy[keep], x_band_loc
