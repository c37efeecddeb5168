"""Matrix-weighted norm g = sqrt(x^T W x) — the counterpart of
gnnla_tpu/models/norm.py.

GN-block form: edge update c_ij = W_ij * x_j, vertex update
y_i = x_i * cbar_i, v->g aggregate ybar = sum_i y_i, global update
g = sqrt(ybar). On an indefinite W the square root is NaN, as it should be.
"""

from __future__ import annotations

import torch

from gnnla_tpu_torch.core import GNBlock, GraphState
from gnnla_tpu_torch.ops.sparse import SparseOperator


def _edge_fn(v_i, v_j, e, g):
    w_ij = e[:, :1]
    return torch.cat([w_ij, w_ij * v_j[:, :1]], dim=1)


def _vertex_fn(v, e, agg, g):
    x = v[:, 0]
    return torch.stack([x, x * agg.sum(e[:, 1])], dim=1)


def _global_fn(v, e, g, vagg, eagg):
    return torch.sqrt(vagg.sum(v[:, 1]))


WeightedNormBlock = GNBlock(edge_fn=_edge_fn, vertex_fn=_vertex_fn,
                            global_fn=_global_fn)


def matrix_weighted_norm_gnn(op: SparseOperator,
                             x: torch.Tensor) -> torch.Tensor:
    """The explicit GN-block form; returns the scalar sqrt(x^T W x)."""
    state = GraphState(vertices=x.reshape(-1)[:, None],
                       edges=op.vals[:, None],
                       globals_=op.vals.new_zeros(1))
    return WeightedNormBlock(op, state).globals_


def matrix_weighted_norm(op, x: torch.Tensor) -> torch.Tensor:
    """The fused form: sqrt(x . (W x)) through the operator's matvec."""
    x = x.reshape(-1)
    return torch.sqrt(torch.dot(x, op.matvec(x)))
