"""Band-family edge layouts: the zero-gather aggregation path — the
counterpart of gnnla_tpu/ops/band.py.

The learned models' hot operation is the 4-way (min, mean, sum, max)
edge -> vertex aggregation. Stored in band form, `bands[k, i] =
e(i, i + off_k)`, every reduction over a row's edges is a masked reduction
over the band axis, the source-vertex value of every edge is a shift of x
and the destination-vertex value a broadcast; edge MLPs apply elementwise
on [K, N, F] as on [E, F]. Packing [E] -> [K, N] happens on the host, once
per fixed pattern.

Three layouts, one method surface (`neighbor`, `broadcast`, `mask_pads`,
`multi`, `global_multi`), so GN-block code is layout-agnostic:

  * `BandLayout` / `BandPattern`: one band per diagonal offset, masked;
  * `GridBandLayout` / `GridPattern`: one class per modular (dy, dx) shift
    of a uniform periodic grid pattern (`ops/stencil.py::stencil_classes`):
    no pad slots, 2-D rolls for the source read;
  * `EllLayout` / `EllPattern`: one slot per neighbour (unstructured
    patterns), the pad mask made from the degree vector, a gather for the
    source read.

`choose_edge_layout` picks the cheapest. The patterns carry a leading
batch dimension: vertices [B, N, F], edges [B, K, N, F], graph-level
results [B, F] (the JAX package maps single graphs with vmap). The free
functions keep the JAX package's single-graph signatures, and their
reductions also take leading batch dimensions.

Semantics match `ops/segment.py`: empty rows give 0, the mean divides by
max(degree, 1).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Sequence, Tuple

import numpy as np
import torch

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.ops.stencil import stencil_classes

# cap on ELL slot count (K_max * N): 2^28 slots = 1 GiB of f32 per edge
# feature; beyond this a degree-skewed pattern must not silently run out
# of memory
ELL_MAX_SLOTS = 1 << 28


def _as3(bands: torch.Tensor) -> torch.Tensor:
    """[K, N] -> [K, N, 1]; [..., K, N, F] as is."""
    return bands[:, :, None] if bands.ndim == 2 else bands


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


class GridBandLayout:
    """Stencil-class edge layout of a uniform periodic grid pattern (the
    diffusion FEM family). Edges classify by modular (dy, dx) displacement
    on the h x w grid; a uniform pattern has exactly one edge per (class,
    vertex), so the [K, N] layout has no pad slots and the mean is sum / K.
    Raises ValueError on a non-uniform pattern."""

    __slots__ = ("shifts", "h", "w", "n", "k", "n_edges",
                 "_k_of_edge", "_pos_of_edge")

    def __init__(self, op, h: int, w: int):
        rows, cols, _ = op.host_coo()
        if op.n_rows != h * w:
            raise ValueError(f"n_rows {op.n_rows} != {h}x{w}")
        shifts, k_idx = stencil_classes(rows, cols, h, w)
        k = len(shifts)
        if rows.size != k * h * w:
            raise ValueError(
                f"not uniform: {rows.size} edges != {k} classes x {h * w} "
                f"vertices — use BandLayout")
        cnt = np.zeros((k, h * w), np.int32)
        np.add.at(cnt, (k_idx, rows), 1)
        if not (cnt == 1).all():
            raise ValueError("not uniform: some (class, vertex) slot is "
                             "empty or duplicated — use BandLayout")
        self.shifts = tuple((int(dy), int(dx)) for dy, dx in shifts)
        self.h, self.w = int(h), int(w)
        self.n = h * w
        self.k = k
        self.n_edges = int(rows.size)
        self._k_of_edge = k_idx.astype(np.int64)
        self._pos_of_edge = rows.astype(np.int64)

    def pack(self, vals: np.ndarray) -> np.ndarray:
        """[..., E] edge-order host values -> [..., K, N] class order."""
        vals = np.asarray(vals)
        if vals.shape[-1] != self.n_edges:
            raise ValueError(f"pack: last axis {vals.shape[-1]} != "
                             f"n_edges {self.n_edges}")
        out = np.zeros(vals.shape[:-1] + (self.k, self.n), vals.dtype)
        out[..., self._k_of_edge, self._pos_of_edge] = vals
        return out

    def unpack(self, bands: np.ndarray) -> np.ndarray:
        return np.asarray(bands)[..., self._k_of_edge, self._pos_of_edge]


class EllLayout:
    """Slot-per-neighbour [K, N] edge layout of an unstructured pattern:
    K = the largest row degree, the edges of row i in slots 0..deg[i]-1 in
    CSR order, so the pad mask is `slot < deg[i]`."""

    __slots__ = ("n", "k", "n_edges", "deg", "cols_ell",
                 "_slot_of_edge", "_row_of_edge")

    def __init__(self, rows: np.ndarray, cols: np.ndarray, n_vertices: int):
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        n = int(n_vertices)
        n_edges = int(rows.shape[0])
        deg = np.bincount(rows, minlength=n).astype(np.int32)
        k = int(deg.max()) if n_edges else 1
        starts = np.zeros(n + 1, np.int64)
        np.cumsum(deg, out=starts[1:])
        if n_edges and bool((np.diff(rows) >= 0).all()):
            slot = np.arange(n_edges, dtype=np.int64) - starts[rows]
        else:
            order = np.argsort(rows, kind="stable")
            slot = np.empty(n_edges, np.int64)
            slot[order] = np.arange(n_edges, dtype=np.int64) - \
                starts[rows[order]]
        cols_ell = np.zeros((k, n), np.int32)   # pad slots point at 0
        cols_ell[slot, rows] = cols.astype(np.int32)
        self.n = n
        self.k = max(k, 1)
        self.n_edges = n_edges
        self.deg = deg
        self.cols_ell = cols_ell
        self._slot_of_edge = slot
        self._row_of_edge = rows.astype(np.int64)

    @classmethod
    def from_operator(cls, op) -> "EllLayout":
        rows, cols, _ = op.host_coo()
        return cls(rows, cols, op.n_rows)

    def pack(self, vals: np.ndarray) -> np.ndarray:
        """[..., E] edge-order host values -> [..., K, N] slot order, pad
        slots zero."""
        vals = np.asarray(vals)
        if vals.shape[-1] != self.n_edges:
            raise ValueError(f"pack: last axis {vals.shape[-1]} != "
                             f"n_edges {self.n_edges}")
        out = np.zeros(vals.shape[:-1] + (self.k, self.n), vals.dtype)
        out[..., self._slot_of_edge, self._row_of_edge] = vals
        return out

    def unpack(self, slots: np.ndarray) -> np.ndarray:
        return np.asarray(slots)[..., self._slot_of_edge, self._row_of_edge]


# ------------------------------------------------------------ free functions
def _shift(x: torch.Tensor, off: int, dim: int) -> torch.Tensor:
    if off == 0:
        return x
    n = x.shape[dim]
    if abs(off) >= n:
        return torch.zeros_like(x)
    zshape = list(x.shape)
    zshape[dim] = abs(off)
    z = x.new_zeros(zshape)
    if off > 0:
        return torch.cat([x.narrow(dim, off, n - off), z], dim=dim)
    return torch.cat([z, x.narrow(dim, 0, n + off)], dim=dim)


def band_shift(x: torch.Tensor, off: int) -> torch.Tensor:
    """x[i + off] along axis 0, 0 outside [0, n); x is [N] or [N, F]."""
    return _shift(x, off, 0)


def band_neighbor_values(x: torch.Tensor, offsets: Sequence[int]
                         ) -> torch.Tensor:
    """Source-vertex values per band, out[k, i] = x[i + off_k] (0
    outside): [N] or [N, F] -> [K, N] or [K, N, F]."""
    return torch.stack([band_shift(x, o) for o in offsets], dim=0)


def band_broadcast(y: torch.Tensor, k: int) -> torch.Tensor:
    """Destination-vertex values per band, out[k, i] = y[i]: [N] or
    [N, F] -> [K, N] or [K, N, F] (a view)."""
    return y[None].expand((k,) + tuple(y.shape))


def band_multi_reduce(reduces: Sequence[str], bands: torch.Tensor,
                      mask: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """Concatenated masked reductions over the band axis.

    bands : [K, N] or [..., K, N, F] (pad slots may hold anything)
    mask  : [K, N] bool (True on real edges)
    deg   : [N] float row degree (clamped to >= 1 for the mean)
    returns [..., N, len(reduces) * F] (F = 1 for 2-d input); empty rows
    give 0, as `ops.segment.multi_segment_reduce`."""
    b3 = _as3(bands)
    m3 = mask[:, :, None]
    outs, s = [], None
    for r in reduces:
        if r in ("sum", "mean"):
            if s is None:
                s = torch.where(m3, b3, torch.zeros_like(b3)).sum(dim=-3)
            outs.append(s if r == "sum" else s / deg.clamp_min(1)[:, None])
        elif r in ("max", "min"):
            fill = float("-inf") if r == "max" else float("inf")
            q = torch.where(m3, b3, torch.full_like(b3, fill))
            out = q.amax(dim=-3) if r == "max" else q.amin(dim=-3)
            outs.append(torch.where(out == fill, torch.zeros_like(out), out))
        else:
            raise ValueError(f"unknown reducer {r!r}")
    return torch.cat(outs, dim=-1)


def band_global_multi(reduces: Sequence[str], bands: torch.Tensor,
                      mask: torch.Tensor, n_edges: int) -> torch.Tensor:
    """Whole-graph edge aggregation (rho^{e->g}) in band layout:
    [..., K, N, F] -> [..., len(reduces) * F]. The mean divides by the real
    edge count; max and min of no edge stay -inf and +inf, as the
    single-graph `core.block.NodeAggregator`."""
    b3 = _as3(bands)
    m3 = mask[:, :, None]
    outs, s = [], None
    for r in reduces:
        if r in ("sum", "mean"):
            if s is None:
                s = torch.where(m3, b3, torch.zeros_like(b3)).sum(
                    dim=(-3, -2))
            outs.append(s if r == "sum" else s / max(n_edges, 1))
        elif r == "max":
            outs.append(torch.where(m3, b3, torch.full_like(
                b3, float("-inf"))).amax(dim=(-3, -2)))
        elif r == "min":
            outs.append(torch.where(m3, b3, torch.full_like(
                b3, float("inf"))).amin(dim=(-3, -2)))
        else:
            raise ValueError(f"unknown reducer {r!r}")
    return torch.cat(outs, dim=-1)


def ell_mask(k: int, deg: torch.Tensor) -> torch.Tensor:
    """[K, N] bool pad mask, slot < deg[i], from the [N] degree vector."""
    return torch.arange(k, device=deg.device)[:, None] < deg[None, :]


def ell_multi_reduce(reduces: Sequence[str], slots: torch.Tensor,
                     deg: torch.Tensor) -> torch.Tensor:
    """Masked reductions over the slot axis: slots [K, N] or
    [..., K, N, F], deg [N] int -> [..., N, len(reduces) * F]; empty rows
    give 0."""
    k = slots.shape[0] if slots.ndim == 2 else slots.shape[-3]
    dtype = slots.dtype if slots.is_floating_point() else torch.float32
    return band_multi_reduce(reduces, slots, ell_mask(k, deg),
                             deg.clamp_min(1).to(dtype))


def ell_global_multi(reduces: Sequence[str], slots: torch.Tensor,
                     deg: torch.Tensor, n_edges: int) -> torch.Tensor:
    k = slots.shape[0] if slots.ndim == 2 else slots.shape[-3]
    return band_global_multi(reduces, slots, ell_mask(k, deg), n_edges)


def band_spmv(bands: torch.Tensor, offsets: Sequence[int],
              x: torch.Tensor) -> torch.Tensor:
    """y = A @ x from band-layout values, sum_k bands_k * shift(x, off_k)
    (pad slots must be 0, which `BandLayout.pack` guarantees); x is [N] or
    [N, F]."""
    y = torch.zeros_like(x)
    for kk, off in enumerate(offsets):
        d = bands[kk] if x.ndim == 1 else bands[kk][:, None]
        y = y + d * band_shift(x, off)
    return y


# ----------------------------------------------------------------- patterns
def _grid_reduce(reduces: Sequence[str], e: torch.Tensor, dims,
                 count: int) -> torch.Tensor:
    """Mask-free reductions of e over `dims`; the mean divides by count."""
    outs, s = [], None
    for r in reduces:
        if r in ("sum", "mean"):
            if s is None:
                s = e.sum(dim=dims)
            outs.append(s if r == "sum" else s / count)
        elif r == "max":
            outs.append(e.amax(dim=dims))
        elif r == "min":
            outs.append(e.amin(dim=dims))
        else:
            raise ValueError(f"unknown reducer {r!r}")
    return torch.cat(outs, dim=-1)


@dataclasses.dataclass(frozen=True)
class BandPattern:
    """Device view of a `BandLayout`: what a GN block needs to run on the
    band layout. Batched method surface: vertices [B, N, F], edges
    [B, K, N, F]."""

    mask: torch.Tensor    # [K, N] bool
    deg: torch.Tensor     # [N] float, clamped >= 1
    offsets: Tuple[int, ...]
    n_edges: int

    @property
    def k(self) -> int:
        return len(self.offsets)

    @classmethod
    def from_layout(cls, lay: BandLayout, device="cuda") -> "BandPattern":
        device = resolve_device(device)
        return cls(mask=torch.from_numpy(lay.mask).to(device),
                   deg=torch.from_numpy(np.maximum(lay.deg, 1).astype(
                       np.float32)).to(device),
                   offsets=lay.offsets, n_edges=lay.n_edges)

    @classmethod
    def from_operator(cls, op) -> "BandPattern":
        return cls.from_layout(BandLayout(op), op.device)

    def neighbor(self, x: torch.Tensor) -> torch.Tensor:
        """[B, N, F] -> [B, K, N, F], out[:, k, i] = x[:, i + off_k]."""
        return torch.stack([_shift(x, o, -2) for o in self.offsets], dim=1)

    def broadcast(self, y: torch.Tensor) -> torch.Tensor:
        return y[:, None].expand(y.shape[0], self.k, *y.shape[1:])

    def mask_pads(self, e: torch.Tensor) -> torch.Tensor:
        return torch.where(self.mask[:, :, None], e, torch.zeros_like(e))

    def multi(self, reduces: Sequence[str], e: torch.Tensor) -> torch.Tensor:
        return band_multi_reduce(reduces, e, self.mask, self.deg)

    def global_multi(self, reduces: Sequence[str],
                     e: torch.Tensor) -> torch.Tensor:
        return band_global_multi(reduces, e, self.mask, self.n_edges)


@dataclasses.dataclass(frozen=True)
class GridPattern:
    """Device view of a `GridBandLayout` (no arrays: the layout has no mask
    or degree). Same batched method surface as `BandPattern`."""

    shifts: Tuple[Tuple[int, int], ...]
    h: int
    w: int

    @property
    def k(self) -> int:
        return len(self.shifts)

    @property
    def n_edges(self) -> int:
        return self.k * self.h * self.w

    @classmethod
    def from_layout(cls, lay: GridBandLayout) -> "GridPattern":
        return cls(shifts=lay.shifts, h=lay.h, w=lay.w)

    def neighbor(self, x: torch.Tensor) -> torch.Tensor:
        """[B, N, F] -> [B, K, N, F], the class-k neighbour of each vertex
        by a 2-D roll of the grid."""
        b, f = x.shape[0], tuple(x.shape[2:])
        x2 = x.reshape((b, self.h, self.w) + f)
        outs = [torch.roll(x2, (-dy, -dx), dims=(1, 2))
                for dy, dx in self.shifts]
        return torch.stack(outs, dim=1).reshape(
            (b, self.k, self.h * self.w) + f)

    def broadcast(self, y: torch.Tensor) -> torch.Tensor:
        return y[:, None].expand(y.shape[0], self.k, *y.shape[1:])

    def mask_pads(self, e: torch.Tensor) -> torch.Tensor:
        return e  # no pad slots

    def multi(self, reduces: Sequence[str], e: torch.Tensor) -> torch.Tensor:
        """[..., K, N, F] -> [..., N, len(reduces) * F]; degree K."""
        return _grid_reduce(reduces, _as3(e), -3, self.k)

    def global_multi(self, reduces: Sequence[str],
                     e: torch.Tensor) -> torch.Tensor:
        return _grid_reduce(reduces, _as3(e), (-3, -2), self.n_edges)


@dataclasses.dataclass(frozen=True)
class EllPattern:
    """Device view of an `EllLayout`. Same batched method surface as
    `BandPattern`; the source read is a gather."""

    cols: torch.Tensor    # [K, N] int64 (pad slots -> 0)
    deg: torch.Tensor     # [N] int32
    n_edges: int

    @property
    def k(self) -> int:
        return self.cols.shape[0]

    @classmethod
    def from_layout(cls, lay: EllLayout, device="cuda") -> "EllPattern":
        device = resolve_device(device)
        return cls(cols=torch.from_numpy(lay.cols_ell.astype(np.int64)).to(
            device), deg=torch.from_numpy(lay.deg).to(device),
            n_edges=lay.n_edges)

    @classmethod
    def from_operator(cls, op) -> "EllPattern":
        return cls.from_layout(EllLayout.from_operator(op), op.device)

    def neighbor(self, x: torch.Tensor) -> torch.Tensor:
        """[B, N, F] -> [B, K, N, F] by one gather."""
        b, f = x.shape[0], tuple(x.shape[2:])
        return x.index_select(1, self.cols.reshape(-1)).reshape(
            (b,) + tuple(self.cols.shape) + f)

    def broadcast(self, y: torch.Tensor) -> torch.Tensor:
        return y[:, None].expand(y.shape[0], self.k, *y.shape[1:])

    def mask_pads(self, e: torch.Tensor) -> torch.Tensor:
        m = ell_mask(self.k, self.deg)[:, :, None]
        return torch.where(m, e, torch.zeros_like(e))

    def multi(self, reduces: Sequence[str], e: torch.Tensor) -> torch.Tensor:
        return ell_multi_reduce(reduces, e, self.deg)

    def global_multi(self, reduces: Sequence[str],
                     e: torch.Tensor) -> torch.Tensor:
        return ell_global_multi(reduces, e, self.deg, self.n_edges)


def choose_edge_layout(op, grid_shape=None):
    """The cheapest zero-gather edge layout of a fixed pattern, as
    (layout, pattern on op's device, kind) with kind
      "grid"  a uniform periodic grid pattern (grid_shape given);
      "band"  at most 4x as many distinct offsets as the largest degree;
      "ell"   anything else.
    A pattern that asked for grid_shape and is not uniform warns (the
    fallback stores about twice the edges); an ELL layout of more than
    ELL_MAX_SLOTS slots raises ValueError."""
    if grid_shape is not None:
        try:
            lay = GridBandLayout(op, *grid_shape)
            return lay, GridPattern.from_layout(lay), "grid"
        except ValueError as e:
            warnings.warn(
                f"grid layout requested but pattern is not uniform "
                f"({e}); falling back to a masked layout (~2x edge "
                f"storage)", stacklevel=2)
    rows, cols, _ = op.host_coo()
    n_offsets = int(np.unique(cols.astype(np.int64)
                              - rows.astype(np.int64)).size) if rows.size \
        else 1
    max_deg = int(np.bincount(rows, minlength=op.n_rows).max()) \
        if rows.size else 1
    if n_offsets <= 4 * max_deg:
        lay = BandLayout(op)
        return lay, BandPattern.from_layout(lay, op.device), "band"
    if max_deg * op.n_rows > ELL_MAX_SLOTS:
        raise ValueError(
            f"ELL layout would allocate {max_deg} x {op.n_rows} = "
            f"{max_deg * op.n_rows:.2e} slots for {op.nnz} edges (max "
            f"row degree {max_deg} dominates). This degree-skewed "
            "pattern has no zero-gather layout here yet — run the "
            "edge-order path (ops.segment / make_edge_aggregator), or "
            "split the hub rows before building the layout.")
    lay = EllLayout(rows, cols, op.n_rows)
    return lay, EllPattern.from_layout(lay, op.device), "ell"
