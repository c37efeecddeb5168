"""Isoparametric bilinear-quad stiffness assembly (vectorized, host numpy)
— a copy of gnnla_tpu/problems/quad_fem.py, which the port may not import.

4-node quads, 9-point (3x3) Gauss quadrature on [-1,1]^2, integrand
grad(phi_i) . grad(phi_j) |J| with unit diffusion (the reference's
TrainableJacobiDiag/buildMatrixQuads.py:42-137), optional vertex->node map
for periodic identification. The whole element batch is one einsum over
[n_elems, 9, 4] shape-gradient tensors.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

# 3x3 Gauss points and weights on [-1, 1]
_G = np.sqrt(3.0 / 5.0)
_GP = np.array([[-_G, -_G], [0, -_G], [_G, -_G],
                [-_G, 0], [0, 0], [_G, 0],
                [-_G, _G], [0, _G], [_G, _G]])
_GW = np.array([25, 40, 25, 40, 64, 40, 25, 40, 25]) / 81.0


def _shape_grads(xi, nu):
    """d/dxi and d/dnu of the 4 bilinear shape functions at (xi, nu).

    Node order: (-1,-1), (1,-1), (1,1), (-1,1) — counterclockwise, matching
    the reference's dSdxi/dSdnu (buildMatrixQuads.py:93-116)."""
    dxi = 0.25 * np.array([-(1 - nu), (1 - nu), (1 + nu), -(1 + nu)])
    dnu = 0.25 * np.array([-(1 - xi), -(1 + xi), (1 + xi), (1 - xi)])
    return dxi, dnu


def build_matrix_quads(quads: np.ndarray, xy: np.ndarray,
                       quad_index_to_node: np.ndarray | None = None,
                       alpha: float = 1.0, beta: float = 1.0):
    """Assemble the stiffness matrix K (scipy COO).

    quads : [n_elems, 4] vertex indices (counterclockwise)
    xy    : [n_verts, 2] coordinates
    quad_index_to_node : optional vertex->node map (periodic identification)
    alpha, beta : diagonal diffusion coefficients (x / y)
    """
    if quad_index_to_node is None:
        quad_index_to_node = np.arange(xy.shape[0])
    n = int(np.max(quad_index_to_node)) + 1

    x = xy[quads, 0]   # [n_elems, 4]
    y = xy[quads, 1]

    # shape grads at each Gauss point: [9, 4]
    dxi = np.stack([_shape_grads(p[0], p[1])[0] for p in _GP])
    dnu = np.stack([_shape_grads(p[0], p[1])[1] for p in _GP])

    # jacobian terms per (elem, gp): [n_elems, 9]
    dxdxi = x @ dxi.T
    dydxi = y @ dxi.T
    dxdnu = x @ dnu.T
    dydnu = y @ dnu.T
    detj = dxdxi * dydnu - dxdnu * dydxi

    # physical gradients g{x,y}[e, gp, i]
    gx = (dydnu[:, :, None] * dxi[None] - dydxi[:, :, None] * dnu[None]) \
        / detj[:, :, None]
    gy = (-dxdnu[:, :, None] * dxi[None] + dxdxi[:, :, None] * dnu[None]) \
        / detj[:, :, None]

    w = _GW[None, :] * detj     # [n_elems, 9]
    ke = alpha * np.einsum("eg,egi,egj->eij", w, gx, gx) \
        + beta * np.einsum("eg,egi,egj->eij", w, gy, gy)

    nodes = quad_index_to_node[quads]               # [n_elems, 4]
    rows = np.repeat(nodes, 4, axis=1).ravel()
    cols = np.tile(nodes, (1, 4)).ravel()
    K = sp.coo_matrix((ke.reshape(-1), (rows, cols)), shape=(n, n))
    K.sum_duplicates()
    return K


def structured_quads(nx: int, ny: int):
    """Counterclockwise quads of an (nx x ny)-vertex structured grid."""
    quads = []
    for j in range(ny - 1):
        for i in range(nx - 1):
            idx = i + nx * j
            quads.append([idx, idx + 1, idx + nx + 1, idx + nx])
    return np.array(quads)
