"""Weighted Jacobi relaxation — the counterpart of
gnnla_tpu/models/jacobi.py (the fused form; `jacobi_gnn` comes with the
GN-block slice). The JAX `lax.scan` is a Python loop here."""

from __future__ import annotations

from typing import Optional

import torch


def jacobi(op, b: torch.Tensor, x: torch.Tensor, *, omega: float,
           n_iters: int, diag: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """x <- x + w D^{-1} (b - A x), n_iters times.

    `diag` overrides A's diagonal — the trained-Jacobi diagonal D_i of the
    learned smoother (see gnnla_tpu/models/jacobi.py for why a
    reference-recipe D must not be used in a cycle)."""
    b, x = b.reshape(-1), x.reshape(-1)
    d = op.diagonal() if diag is None else diag.reshape(-1)
    w_over_d = omega / d
    for _ in range(n_iters):
        x = x + w_over_d * (b - op.matvec(x))
    return x
