"""Matrix <-> graph conversions — the counterpart of
gnnla_tpu/core/convert.py.

  * `coo_to_gnn_input`    — edge list + edge attributes, diagonal kept
  * `remove_diag_entries` — drop self-edges from an edge list
  * `matrix_to_graph`     — diagonal-as-vertex-feature split: vertex attr
                            [A_ii], edges = off-diagonal entries
  * `graph_to_matrix`     — the inverse
  * `graph_state_from_matrix` — operator + a GraphState of its values

A `SparseOperator` is the graph (rows/cols are the edge list, row-sorted),
so these re-package views. Where an operator is built, it lands on
`device` (the card unless the caller passes device="cpu").
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gnnla_tpu_torch.core.graph import GraphState
from gnnla_tpu_torch.ops.sparse import SparseOperator


def _host(a) -> np.ndarray:
    """A tensor (any device) or array-like as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def as_operator(A, *, dtype=torch.float32, device="cuda") -> SparseOperator:
    """Coerce scipy sparse / dense ndarray / SparseOperator to an operator
    (a SparseOperator is returned as it is, on its own device)."""
    if isinstance(A, SparseOperator):
        return A
    if hasattr(A, "tocoo"):  # scipy sparse
        return SparseOperator.from_scipy(A, dtype=dtype, device=device)
    return SparseOperator.from_dense(np.asarray(A), dtype=dtype,
                                     device=device)


def coo_to_gnn_input(A, *, dtype=torch.float32, device="cuda"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(edgeij_pair [2, E], edge_attr [E, 1]) with the diagonal kept; edge
    k is the nonzero A[edgeij_pair[0, k], edgeij_pair[1, k]], row-sorted."""
    op = as_operator(A, dtype=dtype, device=device)
    return torch.stack([op.rows, op.cols], dim=0), op.vals[:, None]


def remove_diag_entries(edgeij_pair, edge_attr):
    """Drop self-edges (i == j) from an edge list + attributes (changes
    sizes; tensors stay on their device, numpy input gives CPU tensors)."""
    ij = torch.as_tensor(edgeij_pair)
    e = torch.as_tensor(edge_attr)
    keep = ij[0] != ij[1]
    return ij[:, keep], e[keep]


def matrix_to_graph(A, *, coords: Optional[np.ndarray] = None,
                    dtype=torch.float32, device="cuda"
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               SparseOperator]:
    """Diagonal-as-vertex-feature split.

    Returns (vertex_attr [N, 1] = A_ii, edgeij_pair [2, E], edge_attr, op)
    where op is the diagonal-removed operator whose edges carry the
    off-diagonal A_ij. edge_attr is [E, 1] (A_ij) or [E, 1 + d] when
    `coords` ([N, d]) is given (A_ij plus x_j - x_i per edge)."""
    full = as_operator(A, dtype=dtype, device=device)
    v_attr = full.diagonal()[:, None]
    op = full.remove_diagonal()
    edgeij = torch.stack([op.rows, op.cols], dim=0)
    e_attr = op.vals[:, None]
    if coords is not None:
        rows_h, cols_h, _ = op.host_coo()
        coords = np.asarray(coords, dtype=np.float64)
        rel = coords[cols_h] - coords[rows_h]
        e_attr = torch.cat(
            [e_attr, torch.from_numpy(rel).to(e_attr.dtype).to(op.device)],
            dim=1)
    return v_attr, edgeij, e_attr, op


def graph_to_matrix(vertex_diag, op_nodiag: SparseOperator,
                    edge_vals=None) -> SparseOperator:
    """Inverse of `matrix_to_graph`: re-attach the diagonal to the
    off-diagonal pattern (host-side), on op_nodiag's device."""
    rows, cols, vals = op_nodiag.host_coo()
    if edge_vals is not None:
        vals = _host(edge_vals).astype(np.float64).ravel()
    d = _host(vertex_diag).astype(np.float64).ravel()
    n = d.shape[0]
    return SparseOperator.from_coo(
        np.concatenate([rows, np.arange(n)]),
        np.concatenate([cols, np.arange(n)]),
        np.concatenate([vals, d]),
        (n, max(op_nodiag.shape[1], n)),
        dtype=op_nodiag.vals.dtype, device=op_nodiag.device)


def graph_state_from_matrix(A, *, n_vertex_features: int = 1,
                            dtype=torch.float32, device="cuda"
                            ) -> Tuple[SparseOperator, GraphState]:
    """Operator + a GraphState seeded with the edge values (A_ij) and
    zeroed vertex features — the starting point of the fixed kernels."""
    op = as_operator(A, dtype=dtype, device=device)
    state = GraphState(
        vertices=op.vals.new_zeros((op.n_rows, n_vertex_features)),
        edges=op.vals[:, None])
    return op, state
