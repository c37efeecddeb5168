"""The GN-block engine — the counterpart of gnnla_tpu/core/block.py.

A graph-network block in the reference's ordering:

    1. edge update      e' = edge_fn(v_i, v_j, e, g)           (phi^e)
    2. e->v aggregation + vertex update v' = vertex_fn(...)    (rho^{e->v}, phi^v)
    3. e->g / v->g aggregation + global update g' = ...        (rho^{e->g}, rho^{v->g}, phi^g)

Updates are plain functions; the fixed kernels' close over nothing or
over scalars. Aggregation reaches them as aggregator objects, so a vertex
update can reduce any edge expression.

`EdgeAggregator` reduces per-edge data onto the rows with the segment
reductions of `ops/segment.py`; `make_edge_aggregator` picks the
pattern's `DenseRowLayout` instead where the JAX package does (no mask,
one aggregate per row, at most DENSE_LAYOUT_MAX_EDGES edges).
`NodeAggregator` reduces onto graphs: full-array reductions for one
graph, segment reductions over the batch ids for a `GraphBatch`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from gnnla_tpu_torch.core.graph import GraphBatch, GraphState
from gnnla_tpu_torch.ops import segment
from gnnla_tpu_torch.ops.sparse import SparseOperator

# the JAX package's bound for the dense row layout (its index constants
# were embedded in the compiled program); kept so both packages take the
# same path for the same operator
DENSE_LAYOUT_MAX_EDGES = 1 << 22


class EdgeAggregator:
    """Reduces [E] or [E, F] per-edge data onto vertices over the row
    index; masked-out edges take no part (mean counts real edges only)."""

    def __init__(self, rows: torch.Tensor, n_vertices: int,
                 mask: Optional[torch.Tensor] = None):
        self.rows = rows
        self.n_vertices = n_vertices
        self.mask = mask

    def _masked(self, data: torch.Tensor, fill: float) -> torch.Tensor:
        if self.mask is None:
            return data
        m = self.mask if data.ndim == 1 else self.mask[:, None]
        return torch.where(m, data, torch.full_like(data, fill))

    def sum(self, data: torch.Tensor) -> torch.Tensor:
        return segment.segment_sum(self._masked(data, 0.0), self.rows,
                                   self.n_vertices)

    def mean(self, data: torch.Tensor) -> torch.Tensor:
        ones = data.new_ones(data.shape[:1])
        if self.mask is not None:
            ones = torch.where(self.mask, ones, torch.zeros_like(ones))
        count = segment.segment_sum(ones, self.rows, self.n_vertices)
        if data.ndim > 1:
            count = count[:, None]
        return self.sum(data) / count.clamp_min(1)

    def max(self, data: torch.Tensor) -> torch.Tensor:
        return segment.segment_max(self._masked(data, float("-inf")),
                                   self.rows, self.n_vertices)

    def min(self, data: torch.Tensor) -> torch.Tensor:
        return segment.segment_min(self._masked(data, float("inf")),
                                   self.rows, self.n_vertices)

    def multi(self, reduces: Sequence[str], data: torch.Tensor
              ) -> torch.Tensor:
        """Feature-wise concat of several reductions ([E,F] -> [N, len*F])."""
        data2d = data if data.ndim > 1 else data[:, None]
        return torch.cat([getattr(self, r)(data2d) for r in reduces], dim=-1)


def make_edge_aggregator(op: SparseOperator, n_vertices: int,
                         mask: Optional[torch.Tensor] = None):
    """The pattern's DenseRowLayout where the JAX package takes it, the
    segment-based EdgeAggregator otherwise (masked batches, another vertex
    count, very large operators)."""
    if (mask is None and n_vertices == op.n_rows
            and op.nnz <= DENSE_LAYOUT_MAX_EDGES):
        return op.row_layout()
    return EdgeAggregator(op.rows, n_vertices, mask=mask)


class NodeAggregator:
    """Reduces per-vertex (or per-edge) data onto graphs (rho^{v->g},
    rho^{e->g}).

    For a single graph (graph_ids None) every reducer is a full-array
    reduction of the masked data: max and min of all-masked data are
    -inf and +inf there, not the 0 the segment reducers give an empty
    segment."""

    def __init__(self, graph_ids: Optional[torch.Tensor], n_graphs: int,
                 mask: Optional[torch.Tensor] = None):
        self.graph_ids = graph_ids
        self.n_graphs = n_graphs
        self.mask = mask

    def _masked(self, data: torch.Tensor, fill: float) -> torch.Tensor:
        if self.mask is None:
            return data
        m = self.mask if data.ndim == 1 else self.mask[:, None]
        return torch.where(m, data, torch.full_like(data, fill))

    def sum(self, data: torch.Tensor) -> torch.Tensor:
        if self.graph_ids is None:
            return self._masked(data, 0.0).sum(dim=0)
        return segment.segment_sum(self._masked(data, 0.0), self.graph_ids,
                                   self.n_graphs)

    def mean(self, data: torch.Tensor) -> torch.Tensor:
        if self.graph_ids is None:
            if self.mask is None:
                return data.mean(dim=0)
            count = self.mask.to(data.dtype).sum()
            return self.sum(data) / count.clamp_min(1)
        ones = data.new_ones(data.shape[:1])
        if self.mask is not None:
            ones = torch.where(self.mask, ones, torch.zeros_like(ones))
        count = segment.segment_sum(ones, self.graph_ids, self.n_graphs)
        if data.ndim > 1:
            count = count[:, None]
        return self.sum(data) / count.clamp_min(1)

    def max(self, data: torch.Tensor) -> torch.Tensor:
        if self.graph_ids is None:
            return self._masked(data, float("-inf")).amax(dim=0)
        return segment.segment_max(self._masked(data, float("-inf")),
                                   self.graph_ids, self.n_graphs)

    def min(self, data: torch.Tensor) -> torch.Tensor:
        if self.graph_ids is None:
            return self._masked(data, float("inf")).amin(dim=0)
        return segment.segment_min(self._masked(data, float("inf")),
                                   self.graph_ids, self.n_graphs)

    def multi(self, reduces: Sequence[str], data: torch.Tensor
              ) -> torch.Tensor:
        data2d = data if data.ndim > 1 else data[:, None]
        return torch.cat([getattr(self, r)(data2d) for r in reduces], dim=-1)


# Update-function signatures:
#   edge_fn(v_i, v_j, e, g)               -> e'
#       v_i = vertices gathered at edge rows   [E, Fv]
#       v_j = vertices gathered at edge cols   [E, Fv]
#       g   = per-edge globals ([Fg] single graph, [E, Fg] batched)
#   vertex_fn(v, e, agg, g)               -> v'
#       agg: EdgeAggregator (or DenseRowLayout) over the row index
#       g  : per-vertex globals ([Fg] single, [N, Fg] batched)
#   global_fn(v, e, g, vagg, eagg)        -> g'
#       vagg: NodeAggregator over vertices; eagg: NodeAggregator over edges
Tensor = Optional[torch.Tensor]
EdgeFn = Callable[[Tensor, Tensor, Tensor, Tensor], torch.Tensor]
VertexFn = Callable[[Tensor, Tensor, EdgeAggregator, Tensor], torch.Tensor]
GlobalFn = Callable[[Tensor, Tensor, Tensor, NodeAggregator,
                     NodeAggregator], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class GNBlock:
    """One graph-network block; apply with `block(op, state [, batch])`.

    Any of the three update functions may be None (identity), as in the
    reference's partially populated MetaLayers."""

    edge_fn: Optional[EdgeFn] = None
    vertex_fn: Optional[VertexFn] = None
    global_fn: Optional[GlobalFn] = None

    def __call__(self, op: SparseOperator, state: GraphState,
                 batch: Optional[GraphBatch] = None) -> GraphState:
        v, e, g = state.vertices, state.edges, state.globals_
        edge_mask = batch.edge_mask if batch is not None else None
        vertex_mask = batch.vertex_mask if batch is not None else None
        per_graph = batch is not None and g is not None and g.ndim == 2

        # ---- phi^e ------------------------------------------------------
        if self.edge_fn is not None:
            v_i = v.index_select(0, op.rows) if v is not None else None
            v_j = v.index_select(0, op.cols) if v is not None else None
            g_e = g.index_select(0, batch.edge_graph) if per_graph else g
            e = self.edge_fn(v_i, v_j, e, g_e)

        # ---- rho^{e->v}, phi^v ------------------------------------------
        if self.vertex_fn is not None:
            agg = make_edge_aggregator(op, op.n_rows, mask=edge_mask)
            g_v = g.index_select(0, batch.vertex_graph) if per_graph else g
            v = self.vertex_fn(v, e, agg, g_v)

        # ---- rho^{v->g}, rho^{e->g}, phi^g ------------------------------
        if self.global_fn is not None:
            if batch is None:
                vagg = NodeAggregator(None, 1, mask=vertex_mask)
                eagg = NodeAggregator(None, 1, mask=edge_mask)
            else:
                vagg = NodeAggregator(batch.vertex_graph, batch.n_graphs,
                                      mask=vertex_mask)
                eagg = NodeAggregator(batch.edge_graph, batch.n_graphs,
                                      mask=edge_mask)
            g = self.global_fn(v, e, g, vagg, eagg)

        return GraphState(vertices=v, edges=e, globals_=g)


def chain(blocks: Sequence[GNBlock], op: SparseOperator, state: GraphState,
          batch: Optional[GraphBatch] = None) -> GraphState:
    """Run blocks in sequence (the reference's layer lists, unrolled)."""
    for b in blocks:
        state = b(op, state, batch)
    return state
