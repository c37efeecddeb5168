"""Residual r = b - A x — the counterpart of gnnla_tpu/models/residual.py
(the fused form; `residual_gnn` comes with the GN-block slice)."""

from __future__ import annotations

import torch


def residual(op, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """r = b - A @ x, for any operator with `matvec`."""
    return b - op.matvec(x)
