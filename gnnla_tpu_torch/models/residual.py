"""Residual r = b - A x — the counterpart of gnnla_tpu/models/residual.py.

GN-block form: edge update c_ij = A_ij * x_j, vertex update
r_i = b_i - cbar_i; vertex features [b, x] in, [b, x, r] out.
"""

from __future__ import annotations

import torch

from gnnla_tpu_torch.core import GNBlock, GraphState
from gnnla_tpu_torch.ops.sparse import SparseOperator


def _edge_fn(v_i, v_j, e, g):
    a_ij = e[:, :1]
    return torch.cat([a_ij, a_ij * v_j[:, 1:2]], dim=1)


def _vertex_fn(v, e, agg, g):
    r = v[:, 0] - agg.sum(e[:, 1])
    return torch.cat([v[:, :2], r[:, None]], dim=1)


ResidualBlock = GNBlock(edge_fn=_edge_fn, vertex_fn=_vertex_fn)


def residual_gnn(op: SparseOperator, b: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """The explicit GN-block form; returns r = b - A x as [N]."""
    state = GraphState(vertices=torch.stack([b.reshape(-1), x.reshape(-1)],
                                            dim=1),
                       edges=op.vals[:, None])
    return ResidualBlock(op, state).vertices[:, 2]


def residual(op, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """r = b - A @ x, for any operator with `matvec`."""
    return b - op.matvec(x)
