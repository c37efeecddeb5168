"""2D quad-FEM heat-equation stiffness matrix with anisotropic stretch —
the counterpart of gnnla_tpu/problems/fem_heateqn.py (a copy: the port
imports nothing of the JAX package).

Reimplements the semantics of the reference's
matlab/heateqnfem2dfun.m:52-172: bilinear quads on a structured grid,
stretch factor alpha = h2/h1 (element values from the
Siefert/Sunderland/Tuminaro 2022 stencil, :91), with either OAZ Dirichlet
rows (bcs=1) or eliminated Dirichlet points (bcs=2) per direction. The
anisotropic test problem of the multilevel hierarchies (stretch up to 7)
and of the reference's trainable-Jacobi dataset (gettrainingmatrices.m).

Vectorized numpy assembly (the MATLAB loops over cells become one scatter).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from gnnla_tpu_torch.ops.sparse import SparseOperator

# local cell ordering (matlab :95-99):  4 o--o 3
#                                       1 o--o 2
_XNEIGHBOR = np.array([[0, 1, 0, 0], [1, 0, 0, 0],
                       [0, 0, 0, 1], [0, 0, 1, 0]], dtype=np.float64)
_YNEIGHBOR = np.array([[0, 0, 0, 1], [0, 0, 1, 0],
                       [0, 1, 0, 0], [1, 0, 0, 0]], dtype=np.float64)
_CNEIGHBOR = np.array([[0, 0, 1, 0], [0, 0, 0, 1],
                       [1, 0, 0, 0], [0, 1, 0, 0]], dtype=np.float64)


def element_stiffness(alpha: float) -> np.ndarray:
    """4x4 bilinear-quad element stiffness for stretch factor alpha."""
    vals = (1.0 / (6.0 * alpha)) * np.array([
        2 * alpha**2 + 2, -2 * alpha**2 + 1, alpha**2 - 2, -1 - alpha**2])
    return (vals[0] * np.eye(4) + vals[1] * _XNEIGHBOR
            + vals[2] * _YNEIGHBOR + vals[3] * _CNEIGHBOR)


def heateqn_fem_2d(num_cells, h_all, bcs=(1, 1), *, dtype=torch.float32,
                   device="cuda"):
    """Assemble K for a (nx, ny) cell grid.

    num_cells : (nx, ny) cells per direction
    h_all     : (h1, h2); stretch alpha = h2/h1
    bcs       : per-direction BC code — 1 = OAZ Dirichlet (identity rows),
                2 = eliminated Dirichlet (both directions must be 2),
                0 = natural (no BC rows touched)

    Returns a SparseOperator on `device`. For bcs=(2,2) only interior
    points remain.
    """
    return SparseOperator.from_scipy(
        heateqn_fem_2d_host(num_cells, h_all, bcs), dtype=dtype,
        device=device)


def heateqn_fem_2d_host(num_cells, h_all, bcs=(1, 1)) -> sp.coo_matrix:
    """Host-only (pure numpy/scipy) twin of `heateqn_fem_2d`: the
    assembled matrix as a scipy COO."""
    nx, ny = int(num_cells[0]), int(num_cells[1])
    h = float(h_all[0])
    alpha = float(h_all[1]) / h
    if (bcs[0] == 2) != (bcs[1] == 2):
        raise ValueError("eliminated Dirichlet (2) must be set for all BCs")

    ek = element_stiffness(alpha)
    npts = (nx + 1) * (ny + 1)

    # global indices per cell (vectorized over all cells)
    xid, yid = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
    base = (nx + 1) * yid.ravel() + xid.ravel()           # 0-based corner
    gidx = np.stack([base, base + 1, base + nx + 2, base + nx + 1], axis=1)

    rows = np.repeat(gidx, 4, axis=1).ravel()
    cols = np.tile(gidx, (1, 4)).ravel()
    vals = np.tile(ek.ravel(order="C"), gidx.shape[0])
    K = sp.coo_matrix((vals, (rows, cols)), shape=(npts, npts)).tocsr()

    bottom = np.arange(0, nx + 1)
    top = np.arange((nx + 1) * ny, npts)
    left = np.arange(0, npts, nx + 1)
    right = np.arange(nx, npts, nx + 1)

    def zero_rows_cols(K, idx):
        mask = np.ones(npts, dtype=bool)
        mask[idx] = False
        d = sp.diags(mask.astype(np.float64))
        K = d @ K @ d
        K = K.tolil()
        K[idx, idx] = 1.0
        return K.tocsr()

    if bcs[0] == 1:
        K = zero_rows_cols(K, np.concatenate([left, right]))
    if bcs[1] == 1:
        K = zero_rows_cols(K, np.concatenate([top, bottom]))
    if bcs[0] == 2:  # eliminated: keep interior only
        bc = np.unique(np.concatenate([left, right, top, bottom]))
        keep = np.setdiff1d(np.arange(npts), bc)
        K = K[keep][:, keep]

    K = K.tocoo()
    K.sum_duplicates()
    K.eliminate_zeros()
    return K


def stretched_mesh_matrix(n_cells: int, stretch: float, *,
                          dtype=torch.float32, device="cuda"):
    """Convenience used by the MATLAB training set (train_jacobi_find_d.m:
    59-82, gettrainingmatrices.m): unit h1, stretched h2."""
    return heateqn_fem_2d((n_cells, n_cells), (1.0, stretch), bcs=(2, 2),
                          dtype=dtype, device=device)
