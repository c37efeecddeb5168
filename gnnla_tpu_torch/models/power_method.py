"""Power method for lambda_max — the counterpart of
gnnla_tpu/models/power_method.py.

GN-block form: each power iteration is three blocks
  1. edge c_ij = A_ij b_j ; vertex b <- cbar
  2. vertex y = b^2 ; global n = sqrt(sum y)
  3. vertex b <- b / n
followed by a two-block Rayleigh quotient
  1. edge c_ij = A_ij b_j ; vertex y = b*cbar ; global n_A = sum y
  2. vertex y = b^2 ; global lambda_max = n_A / sum y
State: v = [b, y]; e = [A_ij, c_ij]; g = [n, n_A, lambda_max]. The globals
are tensors throughout, so the estimator is differentiable.
"""

from __future__ import annotations

import torch

from gnnla_tpu_torch.core import GNBlock, GraphState
from gnnla_tpu_torch.ops.sparse import SparseOperator


def _edge_ab(v_i, v_j, e, g):
    a_ij = e[:, :1]
    return torch.cat([a_ij, a_ij * v_j[:, :1]], dim=1)


def _iter_vertex_matvec(v, e, agg, g):
    return torch.stack([agg.sum(e[:, 1]), v[:, 1]], dim=1)


def _vertex_square(v, e, agg, g):
    b = v[:, 0]
    return torch.stack([b, b * b], dim=1)


def _iter_global_norm(v, e, g, vagg, eagg):
    return torch.stack([torch.sqrt(vagg.sum(v[:, 1])), g[1], g[2]])


def _iter_vertex_normalize(v, e, agg, g):
    return torch.stack([v[:, 0] / g[0], v[:, 1]], dim=1)


def _rayleigh_vertex(v, e, agg, g):
    b = v[:, 0]
    return torch.stack([b, b * agg.sum(e[:, 1])], dim=1)


def _rayleigh_global_na(v, e, g, vagg, eagg):
    return torch.stack([g[0], vagg.sum(v[:, 1]), g[2]])


def _rayleigh_global_lambda(v, e, g, vagg, eagg):
    return torch.stack([g[0], g[1], g[1] / vagg.sum(v[:, 1])])


_ITER_BLOCKS = [
    GNBlock(edge_fn=_edge_ab, vertex_fn=_iter_vertex_matvec),
    GNBlock(vertex_fn=_vertex_square, global_fn=_iter_global_norm),
    GNBlock(vertex_fn=_iter_vertex_normalize),
]
_RAYLEIGH_BLOCKS = [
    GNBlock(edge_fn=_edge_ab, vertex_fn=_rayleigh_vertex,
            global_fn=_rayleigh_global_na),
    GNBlock(vertex_fn=_vertex_square, global_fn=_rayleigh_global_lambda),
]


def power_method_gnn(op: SparseOperator, b0: torch.Tensor, *,
                     n_iters: int):
    """The explicit GN-block form. Returns (lambda_max, b) after n_iters."""
    b0 = b0.reshape(-1)
    state = GraphState(
        vertices=torch.stack([b0, torch.zeros_like(b0)], dim=1),
        edges=torch.stack([op.vals, torch.zeros_like(op.vals)], dim=1),
        globals_=op.vals.new_zeros(3))
    for _ in range(n_iters):
        for blk in _ITER_BLOCKS:
            state = blk(op, state)
    for blk in _RAYLEIGH_BLOCKS:
        state = blk(op, state)
    return state.globals_[2], state.vertices[:, 0]


def power_method(op, b0: torch.Tensor, *, n_iters: int):
    """The fused form: n_iters normalised iterations b <- A b / ||A b||,
    then lambda = (b . A b) / (b . b), on the operator's matvec."""
    b = b0.reshape(-1)
    for _ in range(n_iters):
        ab = op.matvec(b)
        b = ab / torch.linalg.vector_norm(ab)
    return torch.dot(b, op.matvec(b)) / torch.dot(b, b), b
