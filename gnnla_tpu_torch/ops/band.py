"""Band layout of a fixed sparsity pattern — the part of
gnnla_tpu/ops/band.py the learned Jacobi smoother's banded features use.

Edges are grouped by their diagonal offset (col - row): band k holds, at
row i, the edge (i, i + offsets[k]) or a pad slot. `BandLayout.pack`
shuffles edge-order values into [K, N] band order on the host, once;
`band_multi_reduce` then reduces over the band axis with no gather, and
`band_shift` reads x[i + off] with zeros outside [0, N).

The grid and ELL layouts of the diffusion model wait for its slice.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


class BandLayout:
    """Host-side band layout of a fixed sparsity pattern.

    offsets : sorted distinct col - row values (K of them)
    mask    : [K, N] bool, True on real edges
    deg     : [N] int32 row degree
    """

    def __init__(self, op):
        rows, cols, _ = op.host_coo()
        n = op.n_rows
        offs = cols.astype(np.int64) - rows.astype(np.int64)
        uniq = np.unique(offs) if offs.size else np.zeros(1, np.int64)
        k = int(uniq.size)
        band_of_edge = np.searchsorted(uniq, offs).astype(np.int64)
        mask = np.zeros((k, n), bool)
        mask[band_of_edge, rows] = True
        if int(mask.sum()) != rows.size:
            raise ValueError("duplicate edges: coalesce the operator "
                             "before building a BandLayout")
        self.offsets: Tuple[int, ...] = tuple(int(o) for o in uniq)
        self.mask = mask
        self.deg = np.bincount(rows, minlength=n).astype(np.int32)
        self.n = int(n)
        self.k = k
        self.n_edges = int(rows.size)
        self._band_of_edge = band_of_edge
        self._row_of_edge = rows.astype(np.int64)

    def pack(self, vals: np.ndarray) -> np.ndarray:
        """[..., E] edge-order host values -> [..., K, N] band order, pad
        slots zero."""
        vals = np.asarray(vals)
        if vals.shape[-1] != self.n_edges:
            raise ValueError(f"pack: last axis {vals.shape[-1]} != "
                             f"n_edges {self.n_edges}")
        out = np.zeros(vals.shape[:-1] + (self.k, self.n), vals.dtype)
        out[..., self._band_of_edge, self._row_of_edge] = vals
        return out

    def unpack(self, bands: np.ndarray) -> np.ndarray:
        """[..., K, N] band order -> [..., E] edge order (host)."""
        return np.asarray(bands)[..., self._band_of_edge, self._row_of_edge]


def band_shift(x: torch.Tensor, off: int) -> torch.Tensor:
    """x[i + off] along axis 0, 0 outside [0, n); x is [N] or [N, F]."""
    if off == 0:
        return x
    n = x.shape[0]
    if abs(off) >= n:
        return torch.zeros_like(x)
    z = x.new_zeros((abs(off),) + tuple(x.shape[1:]))
    if off > 0:
        return torch.cat([x[off:], z], dim=0)
    return torch.cat([z, x[:n + off]], dim=0)


def band_multi_reduce(reduces: Sequence[str], bands: torch.Tensor,
                      mask: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """Concatenated masked reductions over the band axis.

    bands : [K, N] or [K, N, F] (pad slots may hold anything)
    mask  : [K, N] bool (True on real edges)
    deg   : [N] float row degree (clamped to >= 1 for the mean)
    returns [N, len(reduces) * F] (F = 1 for 2-d input); empty rows give 0,
    as `ops.segment.multi_segment_reduce`."""
    b3 = bands if bands.ndim == 3 else bands[:, :, None]
    m3 = mask[:, :, None]
    outs, s = [], None
    for r in reduces:
        if r in ("sum", "mean"):
            if s is None:
                s = torch.where(m3, b3, torch.zeros_like(b3)).sum(dim=0)
            outs.append(s if r == "sum" else s / deg.clamp_min(1)[:, None])
        elif r in ("max", "min"):
            fill = float("-inf") if r == "max" else float("inf")
            q = torch.where(m3, b3, torch.full_like(b3, fill))
            out = q.amax(dim=0) if r == "max" else q.amin(dim=0)
            outs.append(torch.where(out == fill, torch.zeros_like(out), out))
        else:
            raise ValueError(f"unknown reducer {r!r}")
    return torch.cat(outs, dim=-1)
