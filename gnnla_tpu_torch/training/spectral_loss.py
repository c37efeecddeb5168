"""Differentiable spectral (damping-factor) loss of the trainable Jacobi
smoother — the counterpart of gnnla_tpu/training/spectral_loss.py.

The loss per matrix estimates the largest eigenvalue of the error
propagator T = I - omega D^{-1} A on high-frequency modes:

  * exact path (eval only): dense eigenvalues of T, on the host;
  * train path: the Gelfand estimate max_m ||T^k y_m||^{1/k} over m probe
    vectors y_m (k = 3), with probes drawn from high-frequency Fourier
    modes (the reference's TrainableJacobiDiag/loss.py:105-170).

T is never built: each application is y - omega (A y) / d. The probes are
drawn on the host from numpy, as in the JAX package, so both packages see
the same draws; the loss is differentiable in d through autograd.

Three layouts run A y: any operator with a `matvec` (COO, or DIA with a
batch dimension), the stencil rolls (`ops/stencil.py::stencil_matvec`),
and the multi-RHS SpMM kernel K3 (`ops/stream_spmv.py::CsrSpMV` on an
[n, m] block).
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from gnnla_tpu_torch.ops.stencil import stencil_matvec


# --------------------------------------------------------------- probes
def high_freq_probes(n_vertices: int, m: int, xy: Optional[np.ndarray],
                     rng: np.random.Generator) -> np.ndarray:
    """m unit vectors [N, m] from high-frequency Fourier modes: theta_x,
    theta_y ~ U(1, n), accepted when either exceeds n/2, mode =
    sin(theta_x pi x) sin(theta_y pi y) on the vertex coordinates."""
    n = int(math.sqrt(n_vertices))
    if xy is None:
        x = (np.arange(n) + 1) / (n + 1)
        xx, yy = np.meshgrid(x, x, indexing="xy")
        xx, yy = xx.ravel(), yy.ravel()
    else:
        xx, yy = np.asarray(xy)[:, 0], np.asarray(xy)[:, 1]
    cols = []
    while len(cols) < m:
        tx, ty = (n - 1) * rng.random(2) + 1
        if tx > n / 2 or ty > n / 2:
            cols.append(np.sin(tx * np.pi * xx) * np.sin(ty * np.pi * yy))
    Y = np.stack(cols, axis=1)
    return Y / np.linalg.norm(Y, axis=0, keepdims=True)


def uniform_probes(n_vertices: int, m: int,
                   rng: np.random.Generator) -> np.ndarray:
    """m unit vectors uniform on the sphere [N, m]."""
    Y = rng.standard_normal((n_vertices, m))
    return Y / np.linalg.norm(Y, axis=0, keepdims=True)


# ----------------------------------------------------------- propagator
def error_apply(op, diag: torch.Tensor, omega: float,
                y: torch.Tensor) -> torch.Tensor:
    """One application of T = I - omega D^{-1} A, implicit (never built).
    diag [..., N] with y [..., N] or [..., N, m]."""
    d = diag[..., None] if y.ndim > diag.ndim else diag
    return y - omega * op.matvec(y) / d


def _gelfand(norms: torch.Tensor, k: int) -> torch.Tensor:
    """max over the probe axis (last) of the norms, to the power 1/k."""
    return norms.amax(dim=-1) ** (1.0 / k)


def damping_factor_gelfand(op, diag: torch.Tensor, omega: float,
                           probes: torch.Tensor, k: int = 3
                           ) -> torch.Tensor:
    """Gelfand estimate max_m ||T^k y_m||^{1/k}; probes [N, m] unit
    columns. With a batched operator (DIA diagonals [B, K, N]), diag
    [B, N] and probes [B, N, m] give one estimate per matrix [B].
    Differentiable in diag."""
    y = probes
    for _ in range(k):
        y = error_apply(op, diag, omega, y)
    return _gelfand(torch.linalg.vector_norm(y, dim=-2), k)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def dinv_a_spectrum(op, diag) -> np.ndarray:
    """Spectrum of D^{-1} A (host, dense, eval-only); `op` an operator or
    its dense matrix. For symmetric A with positive diag, D^{-1} A is
    similar to D^{-1/2} A D^{-1/2}, so `eigvalsh` applies; general
    eigenvalues otherwise."""
    A = _host(op if isinstance(op, (np.ndarray, torch.Tensor))
              else op.to_dense())
    d = _host(diag)
    if (d > 0).all() and np.allclose(A, A.T, rtol=0.0,
                                     atol=1e-12 * np.abs(A).max()):
        s = 1.0 / np.sqrt(d)
        return np.linalg.eigvalsh(A * s[:, None] * s[None, :])
    return np.linalg.eigvals(A / d[:, None])


def damping_factor_exact(op, diag, omega: float) -> float:
    """Exact |lambda|_max of T via dense eigenvalues (host, eval only)."""
    return float(np.max(np.abs(1.0 - omega * dinv_a_spectrum(op, diag))))


def optimal_omega(op, diag=None) -> float:
    """omega* = 2 / (lmax + lmin) of D^{-1} A (host, dense, eval only)."""
    d = op.diagonal() if diag is None else diag
    evals = np.abs(dinv_a_spectrum(op, d))
    return float(2.0 / (np.max(evals) + np.min(evals)))


# ---------------------------------------------------------- stencil path
def damping_factor_gelfand_stencil(planes: torch.Tensor, shifts,
                                   diag2d: torch.Tensor, omega: float,
                                   probes2d: torch.Tensor, k: int = 3
                                   ) -> torch.Tensor:
    """The Gelfand damping factor with A y as grid rolls
    (`stencil_matvec`), differentiable in the diagonal.

    planes [K, H, W], diag2d [H, W], probes2d [H, W, m] give a scalar; a
    batch (planes [B, K, H, W], diag2d [B, H, W], probes2d [B, H, W, m])
    gives [B]."""
    d = diag2d[..., None]
    y = probes2d
    for _ in range(k):
        y = y - omega * stencil_matvec(planes, shifts, y) / d
    return _gelfand(torch.sqrt(torch.sum(y * y, dim=(-3, -2))), k)


# ------------------------------------------------------------ SpMM path
def damping_factor_gelfand_spmm(spmm, diag: torch.Tensor, omega: float,
                                probes: torch.Tensor, k: int = 3
                                ) -> torch.Tensor:
    """The Gelfand damping factor with A Y on the multi-RHS SpMM kernel K3
    — the unstructured-graph twin of the stencil path: one SpMM per step
    over all m probe columns.

    spmm   : a `CsrSpMV` of the operator in kernel order, linked to its
             transpose for a gradient (`stream_op.csr_pair`)
    diag   : [n] trainable diagonal in kernel order; differentiable
    probes : [n, m] probe block in kernel order

    A gradient in diag runs K3 k times on A and k - 1 times on A^T: the
    first step's input is the fixed probe block, which needs no
    cotangent."""
    d = diag[:, None]
    y = probes
    for _ in range(k):
        y = y - omega * spmm(y) / d
    return _gelfand(torch.linalg.vector_norm(y, dim=0), k)


# ------------------------------------------------------------ batch loss
def loss_batch_stacked(vals: torch.Tensor, op_template, diags: torch.Tensor,
                       probes: torch.Tensor, omega: float = 2.0 / 3.0,
                       k: int = 3) -> torch.Tensor:
    """Mean damping factor over a batch of same-pattern matrices: stacked
    values [B, E] on the template's pattern, diagonals [B, N] and probes
    [B, N, m] (the JAX package's vmap over B, written out as a batch
    dimension of a COO apply)."""
    rows, cols = op_template.rows, op_template.cols

    def matvec(y):  # [B, N, m]
        prod = vals[:, :, None] * y.index_select(1, cols)
        return y.new_zeros(y.shape).index_add_(1, rows, prod)

    return torch.mean(damping_factor_gelfand(
        SimpleNamespace(matvec=matvec), diags, omega, probes, k=k))
