"""Edge -> vertex aggregation (rho^{e->v}) — the part of
gnnla_tpu/core/block.py the learned Jacobi smoother's features use.

`EdgeAggregator` reduces per-edge data onto the rows with the segment
reductions of `ops/segment.py`; `make_edge_aggregator` picks the
pattern's `DenseRowLayout` instead where the JAX package does (no mask,
one aggregate per row, at most DENSE_LAYOUT_MAX_EDGES edges). The GN-block
engine itself (`GNBlock`) is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

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
