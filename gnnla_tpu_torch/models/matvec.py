"""SpMV as a GN block: y = A @ x — the counterpart of
gnnla_tpu/models/matvec.py.

  * edge update    c_ij = A_ij * x_j
  * e->v aggregate cbar_i = sum_j c_ij  (row-wise)
  * vertex update  y_i = cbar_i
A multi-column X ([N, K]) flows through the block as K vertex features.

`matvec_gnn` is the explicit GN-block form on a `SparseOperator`;
`matvec` is the fused form on any operator with `matvec` (on the card:
K1, K2 or the COO gather/scatter-add).
"""

from __future__ import annotations

import torch

from gnnla_tpu_torch.core import GNBlock, GraphState
from gnnla_tpu_torch.ops.sparse import SparseOperator


def _edge_fn(v_i, v_j, e, g):
    a_ij = e[:, :1]
    c_ij = a_ij * v_j
    return torch.cat([a_ij, c_ij], dim=1)


def _vertex_fn(v, e, agg, g):
    cbar = agg.sum(e[:, 1:])
    return torch.cat([v, cbar], dim=1)


MatVecBlock = GNBlock(edge_fn=_edge_fn, vertex_fn=_vertex_fn)


def matvec_gnn(op: SparseOperator, x: torch.Tensor) -> torch.Tensor:
    """The explicit GN-block form; y = A @ X for X of shape [N] or [N, K]."""
    squeeze = x.ndim == 1
    x2 = x[:, None] if squeeze else x
    k = x2.shape[1]
    out = MatVecBlock(op, GraphState(vertices=x2, edges=op.vals[:, None]))
    y = out.vertices[:, k:]
    return y[:, 0] if squeeze else y


def matvec(op, x: torch.Tensor) -> torch.Tensor:
    """The fused form: y = A @ x through the operator's own matvec."""
    return op.matvec(x)
