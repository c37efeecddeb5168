"""AMG direct interpolation as GN blocks — the counterpart of
gnnla_tpu/models/direct_interp.py.

Inputs (diagonal-removed pattern): vertex v = [A_ii, C_i] (C_i = 1 for
coarse points), edge e = [A_ij, S_ij] (S_ij in {0, 1} marks strong
connections).

  * block 1 edge:   w_ij = C_j (the coarse flag of the column vertex)
  * block 1 e->v:   gammabar_i = sum_k A_ik / sum_k (A_ik S_ik C_k)
  * block 1 vertex: alpha_i = gammabar_i / A_ii
  * block 2 edge:   w_ij = (1 - C_i) * (-A_ij * alpha_i)

A row with no strong coarse neighbour divides by zero: its w_ij are inf
or NaN, and (1 - C_i) does not cancel them on C rows. They are left as
they are; `amg.interp.assemble_prolongation` reads only fine rows'
coarse columns.
"""

from __future__ import annotations

import torch

from gnnla_tpu_torch.core import GNBlock, GraphState
from gnnla_tpu_torch.ops.sparse import SparseOperator

_AII, _C, _ALPHA = 0, 1, 2
_A, _S, _W = 0, 1, 2


def _layer1_edge(v_i, v_j, e, g):
    return torch.cat([e[:, :2], v_j[:, _C:_C + 1]], dim=1)


def _layer1_vertex(v, e, agg, g):
    a_ii = v[:, _AII]
    a_ik, s_ik, w_ik = e[:, _A], e[:, _S], e[:, _W]
    alpha = (agg.sum(a_ik) / agg.sum(a_ik * s_ik * w_ik)) / a_ii
    return torch.stack([a_ii, v[:, _C], alpha], dim=1)


def _layer2_edge(v_i, v_j, e, g):
    a_ij = e[:, _A:_A + 1]
    s_ij = e[:, _S:_S + 1]
    c_i = v_i[:, _C:_C + 1]
    alpha_i = v_i[:, _ALPHA:_ALPHA + 1]
    w_ij = (1.0 - c_i) * (-a_ij * alpha_i)
    return torch.cat([a_ij, s_ij, w_ij], dim=1)


DirectInterpLayer1 = GNBlock(edge_fn=_layer1_edge, vertex_fn=_layer1_vertex)
DirectInterpLayer2 = GNBlock(edge_fn=_layer2_edge)


def direct_interp(op_nodiag: SparseOperator, diag: torch.Tensor,
                  coarse_flags: torch.Tensor,
                  strong_flags: torch.Tensor) -> torch.Tensor:
    """Run the two-block direct-interpolation GNN.

    op_nodiag    : diagonal-removed operator (edges = off-diag A_ij)
    diag         : [N] A_ii
    coarse_flags : [N] 1.0 for C points, 0.0 for F points
    strong_flags : [E] 1.0 where the connection is strong

    Returns w_ij per edge [E] — interpolation weights (0 on C-point rows,
    or NaN where their alpha is infinite)."""
    dtype = op_nodiag.vals.dtype
    v = torch.stack([diag.reshape(-1).to(dtype),
                     coarse_flags.reshape(-1).to(dtype)], dim=1)
    e = torch.stack([op_nodiag.vals, strong_flags.reshape(-1).to(dtype)],
                    dim=1)
    state = DirectInterpLayer1(op_nodiag, GraphState(vertices=v, edges=e))
    return DirectInterpLayer2(op_nodiag, state).edges[:, _W]
