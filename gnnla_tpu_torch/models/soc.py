"""Strength-of-connection GN blocks (classical and smoothed-aggregation)
— the counterpart of gnnla_tpu/models/soc.py.

Classical SOC, on the diagonal-removed pattern:
  * block 1: vertex v_i = max_{j != i} (-A_ij)
  * block 2: edge  S_ij = relu(-A_ij / v_i - theta)
SA SOC: one edge update S_ij = A_ij^2 / (A_ii * A_jj), the diagonal as
the vertex feature.
"""

from __future__ import annotations

import torch

from gnnla_tpu_torch.core import GNBlock, GraphState
from gnnla_tpu_torch.ops.sparse import SparseOperator


def _classic_vertex(v, e, agg, g):
    return agg.max(-e[:, 0])[:, None]


def _classic_edge(theta: float):
    def fn(v_i, v_j, e, g):
        a_ij = e[:, :1]
        s_ij = torch.clamp_min(-a_ij / v_i[:, :1] - theta, 0.0)
        return torch.cat([a_ij, s_ij], dim=1)
    return fn


def soc_classic_blocks(theta: float):
    return [GNBlock(vertex_fn=_classic_vertex),
            GNBlock(edge_fn=_classic_edge(theta))]


def soc_classic(op_nodiag: SparseOperator, theta: float) -> torch.Tensor:
    """Classical SOC over the diagonal-removed operator: S_ij per edge
    ([E]); S_ij > 0 marks a strong connection."""
    state = GraphState(
        vertices=op_nodiag.vals.new_zeros((op_nodiag.n_rows, 1)),
        edges=op_nodiag.vals[:, None])
    for blk in soc_classic_blocks(theta):
        state = blk(op_nodiag, state)
    return state.edges[:, 1]


def _sa_edge(v_i, v_j, e, g):
    a_ij = e[:, :1]
    s_ij = (a_ij * a_ij) / (v_i[:, :1] * v_j[:, :1])
    return torch.cat([a_ij, s_ij], dim=1)


SOCSABlock = GNBlock(edge_fn=_sa_edge)


def soc_sa(op_nodiag: SparseOperator, diag: torch.Tensor) -> torch.Tensor:
    """Smoothed-aggregation SOC: S_ij = A_ij^2 / (A_ii A_jj), per edge [E]."""
    state = GraphState(vertices=diag.reshape(-1)[:, None],
                       edges=op_nodiag.vals[:, None])
    return SOCSABlock(op_nodiag, state).edges[:, 1]
