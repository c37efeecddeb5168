"""Segment reductions — the PyTorch counterpart of gnnla_tpu/ops/segment.py.

Only `segment_sum` is ported in this slice: it is the one reduction
`SparseOperator.matvec/rmatvec` needs. Empty segments are 0, as with
torch_scatter.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[s] = sum of data[e] over edges e with segment_ids[e] == s.

    data is [E] or [E, F]; segment_ids is int32/int64 [E]. Unlike
    jax.ops.segment_sum, `index_add_` needs no sorted-ids hint."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)
