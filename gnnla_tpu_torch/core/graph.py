"""Graph containers — the counterpart of gnnla_tpu/core/graph.py.

`GraphState` carries the features a GN block threads through (vertices,
edges, globals); update functions return new states, never mutate one.
Topology lives in `SparseOperator` (rows = aggregation targets, cols =
gather sources). `GraphBatch` holds the segment ids that map the
vertices and edges of a block-diagonal batch to their graphs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from gnnla_tpu_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class GraphState:
    """Features of one (or a batch of) graph(s).

    vertices : [N, Fv]  per-vertex features (matrix rows/cols)
    edges    : [E, Fe]  per-edge features (matrix nonzeros)
    globals_ : [Fg] for a single graph, or [G, Fg] for a batch
    """

    vertices: Optional[torch.Tensor] = None
    edges: Optional[torch.Tensor] = None
    globals_: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "GraphState":
        return dataclasses.replace(self, **kw)

    @property
    def n_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edges.shape[0]

    def vertex_col(self, i: int) -> torch.Tensor:
        """Column i of the vertex features as a flat [N] vector."""
        return self.vertices[:, i]

    def edge_col(self, i: int) -> torch.Tensor:
        return self.edges[:, i]


def columns(*cols: torch.Tensor) -> torch.Tensor:
    """Stack flat [N] vectors into an [N, F] feature matrix."""
    return torch.stack([c.reshape(-1) for c in cols], dim=1)


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """Segment ids for batched graphs.

    vertex_graph : int32 [N]  graph id per vertex
    edge_graph   : int32 [E]  graph id per edge
    n_graphs     : int
    vertex_mask  : optional bool [N]  False on padding vertices
    edge_mask    : optional bool [E]  False on padding edges
    """

    vertex_graph: torch.Tensor
    edge_graph: torch.Tensor
    n_graphs: int
    vertex_mask: Optional[torch.Tensor] = None
    edge_mask: Optional[torch.Tensor] = None

    @staticmethod
    def single(n_vertices: int, n_edges: int,
               device="cuda") -> "GraphBatch":
        dev = resolve_device(device)
        return GraphBatch(
            vertex_graph=torch.zeros(n_vertices, dtype=torch.int32,
                                     device=dev),
            edge_graph=torch.zeros(n_edges, dtype=torch.int32, device=dev),
            n_graphs=1)
