"""Periodic 2-D diffusion FEM: the stiffness matrices of the
diffusion-coefficient model — the counterpart of
gnnla_tpu/problems/diffusion_fem.py.

Element stiffness K_e(i, j) for div(D grad u), D = diag(alpha(x, y),
beta(x, y)), on bilinear quads of side h = 1/n on the periodic unit square
(the reference's DiffCoeffs/FEM.py:49-239), integrated by a tensor-product
Gauss rule vectorized over all n^2 elements. Host numpy: the arrays are the
JAX package's, bit for bit.

Diffusion families:
  * constant:           alpha, beta constants
  * cosine:             alpha = cos^2(2 pi tx x) cos^2(2 pi ty y) + 0.1,
                        beta likewise with its own thetas
  * cosine+convection:  adds a convection field c, the integrand gaining
                        -(c phi_k) . grad phi_l
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from gnnla_tpu_torch.ops.sparse import SparseOperator

# tensor-product Gauss-Legendre rule per element (order 8: exact to ~1e-14
# for the cos^2 fields at the reference's frequencies and mesh sizes)
_NQ = 8
_QP, _QW = np.polynomial.legendre.leggauss(_NQ)


def _basis_and_grads(xi, nu):
    """Bilinear basis on the reference square [0, 1]^2 at points (xi, nu),
    nodes (0,0), (1,0), (1,1), (0,1). Returns phi, dphi/dxi, dphi/dnu,
    each [q, 4]."""
    phi = np.stack([(1 - xi) * (1 - nu), xi * (1 - nu),
                    xi * nu, (1 - xi) * nu], axis=-1)
    dxi = np.stack([-(1 - nu), (1 - nu), nu, -nu], axis=-1)
    dnu = np.stack([-(1 - xi), -xi, xi, (1 - xi)], axis=-1)
    return phi, dxi, dnu


def element_stiffness_field(
        n: int,
        alpha_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
        beta_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
        convection: Optional[Tuple[float, float]] = None,
        reference_symmetrized: bool = False) -> np.ndarray:
    """All element stiffness matrices at once: [n*n, 4, 4], element
    e = j * n + i spanning [i h, (i+1) h] x [j h, (j+1) h], h = 1/n.

    `reference_symmetrized=True` reproduces the reference's assembly
    (FEM.py:122-128): only the k <= l integrals, mirrored below the
    diagonal, which symmetrizes the convection term. The default assembles
    the true nonsymmetric integral."""
    h = 1.0 / n
    pts = 0.5 * (_QP + 1.0)
    wts = 0.5 * _QW
    XI, NU = np.meshgrid(pts, pts, indexing="ij")
    W = np.outer(wts, wts).ravel()              # [q]
    xi, nu = XI.ravel(), NU.ravel()

    phi, dxi, dnu = _basis_and_grads(xi, nu)    # [q, 4]
    i_idx = np.arange(n)
    ex, ey = np.meshgrid(i_idx, i_idx, indexing="ij")
    ex, ey = ex.ravel(), ey.ravel()             # built i-major

    x = (ex[:, None] + xi[None, :]) * h          # [E, q]
    y = (ey[:, None] + nu[None, :]) * h
    a = alpha_fn(x, y)
    b = beta_fn(x, y)

    # (1/h^2) from the two physical gradients times h^2 from dA cancel
    ke = np.einsum("q,eq,qi,qj->eij", W, a, dxi, dxi) \
        + np.einsum("q,eq,qi,qj->eij", W, b, dnu, dnu)
    if convection is not None:
        # -(c phi_k) . grad phi_l integrates to -h sum_q W c.grad(phi_l) phi_k
        cx, cy = convection
        conv = (cx * np.einsum("q,qk,ql->kl", W, phi, dxi)
                + cy * np.einsum("q,qk,ql->kl", W, phi, dnu))
        ke = ke - h * conv[None, :, :]
        if reference_symmetrized:
            ke = np.triu(ke) + np.triu(ke, 1).transpose(0, 2, 1)
    # the reference numbers elements with i = e % n, j = e // n
    order = (ey * n + ex).argsort(kind="stable")
    return ke[order]


def element_to_index_map(k: int, n: int) -> np.ndarray:
    """Periodic vertex indices of element k (reference FEM.py:130-152)."""
    s = np.empty(4, dtype=np.int64)
    s[0] = k
    s[1] = k + 1
    s[2] = k + n + 1
    s[3] = k + n
    if k >= n * (n - 1):          # top row wraps
        s[3] = k - n * (n - 1)
        s[2] = 0 if k == n * n - 1 else s[3] + 1
    if (k + 1) % n == 0:          # right column wraps
        s[1] = k - (n - 1)
        if k != n * n - 1:
            s[2] = s[1] + n
    return s


def assemble_periodic(ke: np.ndarray, n: int) -> sp.coo_matrix:
    """Scatter [n*n, 4, 4] element matrices into the periodic global K:
    all 16 entries of each K_e (reference FEM.py:154-182), duplicates
    summed."""
    maps = np.stack([element_to_index_map(k, n) for k in range(n * n)])
    rows = np.repeat(maps, 4, axis=1).ravel()
    cols = np.tile(maps, (1, 4)).ravel()
    K = sp.coo_matrix((ke.reshape(-1), (rows, cols)), shape=(n * n, n * n))
    K.sum_duplicates()
    return K


def cosine_field(theta_x: float, theta_y: float):
    def fn(x, y):
        return (np.cos(theta_x * 2 * np.pi * x) ** 2
                * np.cos(theta_y * 2 * np.pi * y) ** 2 + 0.1)
    return fn


def constant_field(value: float):
    def fn(x, y):
        return np.full_like(x, value)
    return fn


def constant_diffusion_matrix(alpha: float, beta: float, n: int, *,
                              dtype=torch.float32,
                              device="cuda") -> SparseOperator:
    ke = element_stiffness_field(n, constant_field(alpha),
                                 constant_field(beta))
    return SparseOperator.from_scipy(assemble_periodic(ke, n), dtype=dtype,
                                     device=device)


def cosine_diffusion_matrix(thetas, n: int, *, convection=None,
                            reference_symmetrized: bool = False,
                            dtype=torch.float32,
                            device="cuda") -> SparseOperator:
    """thetas = (theta_alpha_x, theta_alpha_y, theta_beta_x, theta_beta_y),
    as the reference's CosineDiffusionFEM_Builder takes them."""
    tax, tay, tbx, tby = thetas
    ke = element_stiffness_field(n, cosine_field(tax, tay),
                                 cosine_field(tbx, tby),
                                 convection=convection,
                                 reference_symmetrized=reference_symmetrized)
    return SparseOperator.from_scipy(assemble_periodic(ke, n), dtype=dtype,
                                     device=device)


def alpha_beta_targets(thetas, n: int):
    """Per-vertex (alpha_i, beta_i) regression targets on the vertex grid,
    without the +0.1 offset (reference data.py:139-146)."""
    tax, tay, tbx, tby = thetas
    xs = np.linspace(0, 1, n)
    ys = np.linspace(0, 1, n)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    alpha = (np.cos(tax * 2 * np.pi * X) ** 2
             * np.cos(tay * 2 * np.pi * Y) ** 2).ravel()
    beta = (np.cos(tbx * 2 * np.pi * X) ** 2
            * np.cos(tby * 2 * np.pi * Y) ** 2).ravel()
    return alpha, beta
