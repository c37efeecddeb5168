"""Segment reductions — the PyTorch counterpart of gnnla_tpu/ops/segment.py.

Every function takes `segment_ids` of shape [E] (the row of each edge in
matrix terms), `data` of shape [E] or [E, F], and returns [num_segments]
or [num_segments, F].

Empty segments take the JAX package's fill value: 0 for every reducer
(sum and mean by construction, max and min by masking the -inf/+inf a
scatter leaves back to 0).

`DenseRowLayout` is the fixed-pattern form of the learned models' 4-way
(min, mean, sum, max) edge -> vertex aggregation: one static gather into
[N, K, F] and axis reductions, shared by all four reducers.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[s] = sum of data[e] over edges e with segment_ids[e] == s.

    data is [E] or [E, F]; segment_ids is int32/int64 [E]. Unlike
    jax.ops.segment_sum, `index_add_` needs no sorted-ids hint."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_sum(data.new_ones(data.shape[:1]), segment_ids,
                        num_segments)
    count = count.reshape((num_segments,) + (1,) * (data.ndim - 1))
    return total / count.clamp_min(1)


def _segment_extreme(data, segment_ids, num_segments, reduce, fill):
    ids = segment_ids.long()
    if data.ndim > 1:
        ids = ids.reshape((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), fill)
    out = out.scatter_reduce(0, ids, data, reduce, include_self=True)
    return torch.where(out == fill, torch.zeros_like(out), out)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment max; empty (or all -inf) segments are 0, as in JAX."""
    return _segment_extreme(data, segment_ids, num_segments, "amax",
                            float("-inf"))


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment min; empty (or all +inf) segments are 0, as in JAX."""
    return _segment_extreme(data, segment_ids, num_segments, "amin",
                            float("inf"))


_REDUCERS = {
    "sum": segment_sum,
    "mean": segment_mean,
    "max": segment_max,
    "min": segment_min,
}


def segment_reduce(reduce: str, data: torch.Tensor,
                   segment_ids: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """Dispatch on reducer name ('sum' | 'mean' | 'max' | 'min')."""
    try:
        fn = _REDUCERS[reduce]
    except KeyError:
        raise ValueError(f"unknown reducer {reduce!r}; "
                         f"expected one of {sorted(_REDUCERS)}") from None
    return fn(data, segment_ids, num_segments)


def multi_segment_reduce(reduces: Sequence[str], data: torch.Tensor,
                         segment_ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """Several reductions concatenated feature-wise:
    [E, F] -> [num_segments, len(reduces) * F]."""
    data2d = data if data.ndim > 1 else data[:, None]
    return torch.cat([segment_reduce(r, data2d, segment_ids, num_segments)
                      for r in reduces], dim=-1)


def segment_normalize(data: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Divide each element by the L2 norm of its segment (an all-zero
    segment gives NaN, as in JAX)."""
    norms = torch.sqrt(segment_sum(data * data, segment_ids, num_segments))
    return data / norms[segment_ids.long()]


class DenseRowLayout:
    """Padded row-major edge layout of a fixed pattern: [N, K] gather
    indices (K = the largest row degree) and a mask, built on the host
    from the edges' rows. At run time one gather gives [N, K, F] and every
    reducer is an axis reduction over it; a pure reshape stands in for the
    gather when all rows have degree K and the edges are row-contiguous.
    Empty rows give 0, like the segment_* functions."""

    def __init__(self, rows: np.ndarray, n_vertices: int):
        rows = np.asarray(rows)
        if rows.ndim != 1:
            raise ValueError("DenseRowLayout needs a 1-d host row array")
        n_edges = rows.shape[0]
        deg = np.bincount(rows, minlength=n_vertices)
        k = int(deg.max()) if n_edges else 1
        sorted_contig = bool((np.diff(rows) >= 0).all()) if n_edges else True
        self.n_vertices = int(n_vertices)
        self.k = k
        self.n_edges = int(n_edges)
        self.deg = deg.astype(np.int32)
        self.is_reshape = (bool((deg == k).all()) and sorted_contig
                           and n_edges == n_vertices * k)
        self.gather_idx = self.mask = None
        self._dev: Dict[torch.device, tuple] = {}
        if self.is_reshape:
            return
        # slot of each edge within its row (edges need not be row-sorted)
        starts = np.zeros(n_vertices + 1, np.int64)
        np.cumsum(deg, out=starts[1:])
        if sorted_contig:
            slot = np.arange(n_edges, dtype=np.int64) - starts[rows]
        else:
            order = np.argsort(rows, kind="stable")
            slot = np.empty(n_edges, np.int64)
            slot[order] = np.arange(n_edges, dtype=np.int64) - \
                starts[rows[order]]
        gather = np.zeros((n_vertices, k), np.int64)  # pad -> edge 0
        mask = np.zeros((n_vertices, k), bool)
        gather[rows, slot] = np.arange(n_edges, dtype=np.int64)
        mask[rows, slot] = True
        self.gather_idx = gather
        self.mask = mask

    def _on(self, device: torch.device):
        """(gather [N*K], mask [N, K, 1], deg [N, 1]) on `device`, made
        once per device."""
        if device not in self._dev:
            gather = mask = None
            if not self.is_reshape:
                gather = torch.from_numpy(self.gather_idx.reshape(-1)).to(
                    device)
                mask = torch.from_numpy(self.mask[:, :, None]).to(device)
            deg = torch.from_numpy(self.deg[:, None]).to(device)
            self._dev[device] = (gather, mask, deg)
        return self._dev[device]

    def padded(self, data: torch.Tensor) -> torch.Tensor:
        """[E, F] (or [E]) -> [N, K, F] with pad slots zeroed."""
        data2d = data if data.ndim > 1 else data[:, None]
        f = data2d.shape[-1]
        if self.is_reshape:
            return data2d.reshape(self.n_vertices, self.k, f)
        gather, mask, _ = self._on(data.device)
        p = data2d.index_select(0, gather).reshape(self.n_vertices, self.k, f)
        return torch.where(mask, p, torch.zeros_like(p))

    def _reduce_all(self, reduces: Sequence[str], data: torch.Tensor,
                    keep_2d: bool = True) -> torch.Tensor:
        was_1d = data.ndim == 1
        p = self.padded(data)                       # [N, K, F], pads = 0
        _, mask, deg = self._on(data.device)
        outs, s = [], None
        for r in reduces:
            if r in ("sum", "mean"):
                if s is None:
                    s = p.sum(dim=1)
                outs.append(s if r == "sum"
                            else s / deg.to(p.dtype).clamp_min(1))
            elif r in ("max", "min"):
                fill = float("-inf") if r == "max" else float("inf")
                q = p if mask is None else torch.where(
                    mask, p, torch.full_like(p, fill))
                out = q.amax(dim=1) if r == "max" else q.amin(dim=1)
                outs.append(torch.where(out == fill, torch.zeros_like(out),
                                        out))
            else:
                raise ValueError(f"unknown reducer {r!r}")
        out = torch.cat(outs, dim=-1)
        if was_1d and not keep_2d:
            return out[:, 0]  # 1-d in -> 1-d out, like segment_*
        return out

    # EdgeAggregator-compatible surface
    def sum(self, data: torch.Tensor) -> torch.Tensor:
        return self._reduce_all(("sum",), data, keep_2d=False)

    def mean(self, data: torch.Tensor) -> torch.Tensor:
        return self._reduce_all(("mean",), data, keep_2d=False)

    def max(self, data: torch.Tensor) -> torch.Tensor:
        return self._reduce_all(("max",), data, keep_2d=False)

    def min(self, data: torch.Tensor) -> torch.Tensor:
        return self._reduce_all(("min",), data, keep_2d=False)

    def multi(self, reduces: Sequence[str], data: torch.Tensor
              ) -> torch.Tensor:
        """All reductions off one gather ([E, F] -> [N, len(reduces)*F])."""
        return self._reduce_all(tuple(reduces), data)
