"""Block-diagonal graph batching — the counterpart of
gnnla_tpu/core/batch.py.

Mixed-pattern or mixed-size graphs are stacked into one block-diagonal
operator with vertex-index offsets, plus a `GraphBatch` mapping vertices
and edges to their graph, so every kernel and `GNBlock` runs on the batch
unchanged and per-graph global aggregations are segment reductions over
the batch ids. Construction is host-side.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from gnnla_tpu_torch.core.graph import GraphBatch, GraphState
from gnnla_tpu_torch.ops.sparse import SparseOperator


def batch_operators(ops: Sequence[SparseOperator]
                    ) -> Tuple[SparseOperator, GraphBatch]:
    """Stack operators into one block-diagonal operator + batch ids, on
    the first operator's device.

    Graph k's vertices occupy rows [sum_{i<k} n_i, sum_{i<=k} n_i); edges
    keep their row-sorted order within each block, so the global edge list
    stays row-sorted."""
    if not ops:
        raise ValueError("batch_operators needs at least one operator")
    rows, cols, vals = [], [], []
    v_ids, e_ids = [], []
    off = 0
    for k, op in enumerate(ops):
        if op.shape[0] != op.shape[1]:
            raise ValueError("batching expects square per-graph operators")
        r, c, v = op.host_coo()
        rows.append(r + off)
        cols.append(c + off)
        vals.append(v)
        v_ids.append(np.full(op.n_rows, k, dtype=np.int32))
        e_ids.append(np.full(r.shape[0], k, dtype=np.int32))
        off += op.n_rows

    dev = ops[0].device
    big = SparseOperator.from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
        (off, off), dtype=ops[0].vals.dtype, coalesce=False, device=dev)
    batch = GraphBatch(
        vertex_graph=torch.from_numpy(np.concatenate(v_ids)).to(dev),
        edge_graph=torch.from_numpy(np.concatenate(e_ids)).to(dev),
        n_graphs=len(ops))
    return big, batch


def batch_states(states: Sequence[GraphState]) -> GraphState:
    """Concatenate per-graph feature states along the vertex/edge axes;
    globals stack to [G, Fg] (the batched-global convention GNBlock
    broadcasts per edge/vertex)."""
    def cat(xs):
        xs = [x for x in xs if x is not None]
        return torch.cat(xs, dim=0) if xs else None

    globals_ = [s.globals_ for s in states]
    g = None
    if any(x is not None for x in globals_):
        g = torch.stack([x.reshape(-1) for x in globals_], dim=0)
    return GraphState(vertices=cat([s.vertices for s in states]),
                      edges=cat([s.edges for s in states]),
                      globals_=g)


def graph_sizes(ops: Sequence[SparseOperator]) -> List[int]:
    return [op.n_rows for op in ops]


def unbatch_vertices(v: torch.Tensor, sizes: Sequence[int],
                     axis: int = 0) -> List[torch.Tensor]:
    """Split a stacked vertex array back into per-graph arrays (views)."""
    out, start = [], 0
    for n in sizes:
        out.append(v.narrow(axis, start, n))
        start += n
    return out
