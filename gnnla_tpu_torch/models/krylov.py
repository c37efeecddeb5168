"""Krylov solvers — the counterpart of gnnla_tpu/models/krylov.py: CG, CG
preconditioned by one two-grid V-cycle (`amg_pcg`) and by one multilevel
V-cycle (`mg_pcg`, the large-scale solve path).

The JAX `lax.scan` is a Python loop with no host synchronisation inside
it: the scalars (alpha, beta) stay on the device, and the residual-norm
history is stacked there and returned as one [n_iters] tensor.

Sign convention: CG needs an SPD operator. The framework's Laplacian
fixture is negative definite (diag -4); `flip_sign=True` solves A x = b by
running CG on (-A) x = -b.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from gnnla_tpu_torch.models.multigrid import MultigridSetup, multigrid_cycle
from gnnla_tpu_torch.models.vcycle import TwoGridSetup, vcycle
from gnnla_tpu_torch.utils.program import span


def cg(matvec: Callable, b: torch.Tensor, x0: torch.Tensor, *,
       n_iters: int, precond: Optional[Callable] = None):
    """Preconditioned conjugate gradients.

    matvec  : x -> A x (SPD operator)
    precond : r -> M^-1 r (None = identity); an SPD preconditioner
              application, e.g. one symmetric V-cycle from zero.
    Returns (x, residual-norm history [n_iters]), both on the device.
    The JAX package's guards stay: a zero p.Ap or r.z divides by 1. The
    whole solve is the span `pcg` (`utils/program.py`)."""
    with span("pcg"):
        b, x = b.reshape(-1), x0.reshape(-1)
        r = b - matvec(x)
        z = precond(r) if precond is not None else r
        p = z
        rz = torch.dot(r, z)
        hist = []
        for _ in range(n_iters):
            ap = matvec(p)
            denom = torch.dot(p, ap)
            alpha = rz / torch.where(denom == 0, torch.ones_like(denom), denom)
            x = x + alpha * p
            r = r - alpha * ap
            z = precond(r) if precond is not None else r
            rz_new = torch.dot(r, z)
            beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
            p = z + beta * p
            rz = rz_new
            hist.append(torch.linalg.vector_norm(r))
        return x, (torch.stack(hist) if hist else b.new_zeros(0))


def amg_pcg(setup: TwoGridSetup, b: torch.Tensor, x0: torch.Tensor, *,
            n_iters: int, n_smooth: int = 1, omega: float = 0.7,
            coarse_deg: int = 4, flip_sign: bool = False):
    """CG preconditioned by one two-grid V-cycle per iteration, from a
    zero guess with symmetric pre/post smoothing (an SPD preconditioner
    for an SPD operator). The cycle is linear in its right-hand side, so
    (sA)^-1 r = A^-1 (s r) ~= cycle(s r)."""
    s = -1.0 if flip_sign else 1.0
    A = setup.A

    def matvec(v):
        return s * A.matvec(v)

    def precond(r):
        return vcycle(setup, s * r, torch.zeros_like(r), n_pre=n_smooth,
                      n_post=n_smooth, omega=omega, coarse_deg=coarse_deg)

    return cg(matvec, s * b.reshape(-1), x0, n_iters=n_iters,
              precond=precond)


def mg_pcg(setup: MultigridSetup, b: torch.Tensor, x0: torch.Tensor, *,
           n_iters: int, n_smooth: int = 1, omega: float = 0.7,
           coarse_deg: int = 8, flip_sign: bool = False):
    """CG preconditioned by one multilevel V-cycle per iteration: with a
    full hierarchy the preconditioner's quality is size-independent, so
    the iterations to a fixed tolerance stay flat as the problem grows."""
    if not isinstance(setup, MultigridSetup):
        raise TypeError("mg_pcg takes a MultigridSetup")
    s = -1.0 if flip_sign else 1.0
    A = setup.As[0]

    def matvec(v):
        return s * A.matvec(v)

    def precond(r):
        return multigrid_cycle(setup, s * r, torch.zeros_like(r),
                               n_pre=n_smooth, n_post=n_smooth, omega=omega,
                               coarse_deg=coarse_deg)

    return cg(matvec, s * b.reshape(-1), x0, n_iters=n_iters,
              precond=precond)
