"""Chebyshev relaxation — the counterpart of gnnla_tpu/models/chebyshev.py
(the fused form; `chebyshev_gnn` comes with the GN-block slice)."""

from __future__ import annotations

import torch


def chebyshev(op, b: torch.Tensor, x: torch.Tensor, *, c: float, d: float,
              deg: int) -> torch.Tensor:
    """Degree-`deg` Chebyshev recurrence on fused SpMVs (same k == 2 and
    k > 2 beta formulas as the JAX package)."""
    b, x = b.reshape(-1), x.reshape(-1)
    if deg <= 0:
        return x
    r = b - op.matvec(x)
    alpha = 1.0 / d
    p = r
    x = x + alpha * p
    for k in range(2, deg + 1):
        z = op.matvec(p)
        r = r - alpha * z
        beta = 0.5 * (c * alpha) ** 2 if k == 2 else ((c * alpha) / 2.0) ** 2
        alpha = 1.0 / (d - beta / alpha)
        p = r + beta * p
        x = x + alpha * p
    return x
