"""Weighted Jacobi relaxation — the counterpart of
gnnla_tpu/models/jacobi.py. The JAX `lax.scan` is a Python loop here.

GN-block form: edge update c_ij = A_ij * x_j, vertex update
x_i <- x_i + w * (b_i - cbar_i) / A_ii; vertex features [A_ii, b, x],
edges [A_ij, c_ij], globals [w].
"""

from __future__ import annotations

from typing import Optional

import torch

from gnnla_tpu_torch.core import GNBlock, GraphState
from gnnla_tpu_torch.ops.sparse import SparseOperator


def _edge_fn(v_i, v_j, e, g):
    a_ij = e[:, :1]
    return torch.cat([a_ij, a_ij * v_j[:, 2:3]], dim=1)


def _vertex_fn(v, e, agg, g):
    a_ii, b, x = v[:, 0], v[:, 1], v[:, 2]
    x = x + g[0] * (b - agg.sum(e[:, 1])) / a_ii
    return torch.stack([a_ii, b, x], dim=1)


JacobiBlock = GNBlock(edge_fn=_edge_fn, vertex_fn=_vertex_fn)


def jacobi_gnn(op: SparseOperator, b: torch.Tensor, x: torch.Tensor, *,
               omega: float, n_iters: int) -> torch.Tensor:
    """The explicit GN-block form; returns x after n_iters sweeps."""
    state = GraphState(
        vertices=torch.stack([op.diagonal(), b.reshape(-1), x.reshape(-1)],
                             dim=1),
        edges=torch.stack([op.vals, torch.zeros_like(op.vals)], dim=1),
        globals_=op.vals.new_tensor([omega]))
    for _ in range(n_iters):
        state = JacobiBlock(op, state)
    return state.vertices[:, 2]


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
