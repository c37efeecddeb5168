"""Kernel K6, the windowed ELL SpMV — the counterpart of
scratch/proto_ellw.py, a whole SpMV design for general graphs that the
JAX package prototyped beside its stream kernel.

The layout cuts the rows into 1024-row tiles. Tile t reads x only in the
window [start[t], start[t] + W); its K slots (K = the longest row) hold
one column (less start[t]) and one value per row each, padded slots a
value of 0 and the row's first column.

  * `build_ellw`      — the layout of a scipy CSR, every array and scalar
                        bitwise proto_ellw.py's `build_ellw`.
  * `from_slots`      — the layout of per-row slot arrays cols, vals
                        [n, K] (duplicate columns stay separate slots).
  * `slot_extents`    — for each tile, the slots K6 must read (the rest
                        are padding) and the window words they touch: the
                        port's own data, built once.
  * `ellw_spmv_plain` — the plain PyTorch version.
  * `ellw_cuda`       — the raw launch of K6 (`csrc/ellw_spmv.cu`): on the
                        extents, or without them the earlier full-slot
                        body, which only a timing launches.
  * `EllwSpMV`        — the wrapper: the layout and its extents on one
                        device, `matvec` (K6 on a CUDA tensor, counted in
                        `launches`; the plain version on a CPU tensor),
                        `plain()`, and the window path chosen once from W.
"""

from __future__ import annotations

import numpy as np
import torch

from gnnla_tpu_torch import _build

TILE = 1024  # rows per tile (8 lane-groups of 128)
# K6 stages a tile's window in shared memory when W words take at most
# this many bytes: the most that still lets two 1024-thread blocks share
# an SM (2 x (window + 16-byte barrier + 1 KB the card reserves a block)
# within its 228 KB), rounded down to whole 128-word chunks; a wider
# window is read through the read-only cache by the same kernel
ELLW_SMEM_BYTES = 225 * 512


def _pack(indptr: np.ndarray, cols: np.ndarray, vals: np.ndarray,
          n: int) -> dict:
    """The windowed ELL arrays of a row-ordered entry list: proto_ellw.py
    :15-63, step for step (its padding rule included)."""
    deg = np.diff(indptr)
    K = int(deg.max())
    n_tiles = -(-n // TILE)
    L = n_tiles * TILE

    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    slot = np.arange(cols.size, dtype=np.int64) - indptr[rows]
    tile = rows // TILE

    bnd = np.searchsorted(rows, np.arange(n_tiles) * TILE)
    min_c = np.minimum.reduceat(cols, bnd)
    max_c = np.maximum.reduceat(cols, bnd)
    start = (min_c // 128) * 128
    W = int((max_c - start + 1).max())
    W = -(-W // 128) * 128
    if W > L:
        raise ValueError(f"window {W} exceeds padded length {L}")
    start = np.minimum(start, L - W)

    # a padded slot holds the row's first stored column, so it never
    # widens the window; the rows past n take the last real row's
    first_local = cols[indptr[:-1]] - start[np.arange(n) // TILE]
    first_local = np.concatenate(
        [first_local, np.full(L - n, first_local[-1] if n else 0)])
    g = (rows % TILE) // 128
    lane = rows % 128
    sub = slot * 8 + g

    idx = np.zeros((n_tiles, K * 8, 128), np.int32)
    idx[:] = first_local.reshape(n_tiles, 8, 128)[:, None, :, :].reshape(
        n_tiles, 1, 8, 128).repeat(K, 1).reshape(n_tiles, K * 8, 128)
    val = np.zeros((n_tiles, K * 8, 128), np.float32)
    idx[tile, sub, lane] = (cols - start[tile]).astype(np.int32)
    val[tile, sub, lane] = vals

    hi = idx >> 7
    bounds = np.stack([hi.reshape(n_tiles, K, 8 * 128).min(axis=2),
                       hi.reshape(n_tiles, K, 8 * 128).max(axis=2) + 1],
                      axis=-1).astype(np.int32)
    return dict(idx=idx, val=val, start=start.astype(np.int32),
                bounds=bounds, n=n, W=W, K=K, n_tiles=n_tiles, L=L,
                nnz=cols.size)


def build_ellw(A_csr) -> dict:
    """Host setup: a scipy CSR (columns sorted in each row) -> the
    windowed ELL arrays idx, val [n_tiles, 8K, 128], start [n_tiles],
    bounds [n_tiles, K, 2] and the scalars n, W, K, n_tiles, L, nnz."""
    return _pack(A_csr.indptr.astype(np.int64),
                 A_csr.indices.astype(np.int64),
                 A_csr.data.astype(np.float32), A_csr.shape[0])


def from_slots(cols, vals) -> dict:
    """The windowed ELL arrays of per-row slots cols (int) and vals
    (f32) [n, K]: row r's slot k is entry (r, cols[r, k], vals[r, k]).
    Duplicate columns stay separate slots (y sums them)."""
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float32)
    if cols.ndim != 2 or cols.shape != vals.shape or cols.shape[1] < 1:
        raise ValueError(f"from_slots: cols {cols.shape} and vals "
                         f"{vals.shape} must both be [n, K >= 1]")
    n, K = cols.shape
    return _pack(np.arange(0, n * K + 1, K, dtype=np.int64),
                 cols.reshape(-1), vals.reshape(-1), n)


def slot_extents(idx: np.ndarray, val: np.ndarray) -> np.ndarray:
    """int32 [n_tiles, 4]: for each tile, T, lo, hi, 0.

    T is the smallest k >= 1 such that every slot k..K-1 of the tile is
    padding: value bits exactly +0.0 and the column of the row's slot 0
    (an explicit zero on another column is not padding). K6 sums slots
    0..T-1 and, if T < K, the one term 0 * x[slot 0's column], which is
    the sum over all K slots bit for bit. [lo, hi) holds every window
    word the tile reads, lo rounded down and hi up to a multiple of 4."""
    n_tiles, k8, _ = idx.shape
    i = np.asarray(idx).reshape(n_tiles, k8 // 8, TILE)
    pad = ((np.ascontiguousarray(val, np.float32).view(np.uint32)
            .reshape(i.shape) == 0) & (i == i[:, :1, :])).all(axis=2)
    trailing = np.cumprod(pad[:, ::-1], axis=1).sum(axis=1)
    out = np.zeros((n_tiles, 4), np.int32)
    out[:, 0] = np.maximum(k8 // 8 - trailing, 1)
    out[:, 1] = i.min(axis=(1, 2)) // 4 * 4
    out[:, 2] = -(-(i.max(axis=(1, 2)) + 1) // 4) * 4
    return out


def ellw_spmv_plain(idx: torch.Tensor, val: torch.Tensor,
                    start: torch.Tensor, x: torch.Tensor,
                    W: int) -> torch.Tensor:
    """K6's plain version: y[t, r] = sum over slots k in order from 0 of
    val[t, k, r] * x_pad[start[t] + idx[t, k, r]], x_pad being x padded
    with zeros to the last window's end. Returns [n_tiles * 1024]."""
    n_tiles = start.shape[0]
    K = idx.shape[1] // 8
    L = n_tiles * TILE
    x_pad = x.new_zeros(max(L + W, x.shape[0]))
    x_pad[:x.shape[0]] = x
    cols = start.long()[:, None, None] + idx.long().reshape(n_tiles, K, TILE)
    prods = val.reshape(n_tiles, K, TILE) * x_pad[cols]
    acc = torch.zeros((n_tiles, TILE), dtype=x.dtype, device=x.device)
    for k in range(K):
        acc = acc + prods[:, k]
    return acc.reshape(-1)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ellw_spmv: {msg}")


def ellw_cuda(idx: torch.Tensor, val: torch.Tensor, start: torch.Tensor,
              x: torch.Tensor, W: int, shared: bool,
              seg: torch.Tensor = None) -> torch.Tensor:
    """Launch K6: y [n_tiles * 1024] = A x for the layout idx int32, val
    f32 [n_tiles, 8K, 128], start int32 [n_tiles] and x f32 [n_x], all
    contiguous on one CUDA device; `shared` stages each window in shared
    memory, else the kernel reads x through the read-only cache. With
    `seg`, the `slot_extents` of the layout (int32 on the same device),
    each tile reads only its slots and its part of the window; without it
    the earlier body walks every slot."""
    _require(x.device.type == "cuda", f"x lies on {x.device}, not CUDA")
    _require(all(t.device == x.device for t in (idx, val, start)),
             "idx, val, start and x must share one device")
    _require(idx.dtype == torch.int32 and start.dtype == torch.int32
             and val.dtype == torch.float32 and x.dtype == torch.float32,
             "idx and start must be int32, val and x float32")
    n_tiles = start.shape[0]
    _require(idx.ndim == 3 and idx.shape == val.shape
             and idx.shape[0] == n_tiles and idx.shape[1] % 8 == 0
             and idx.shape[2] == 128 and x.ndim == 1,
             f"shapes idx {tuple(idx.shape)}, val {tuple(val.shape)}, "
             f"start {tuple(start.shape)}, x {tuple(x.shape)}")
    _require(W > 0 and W % 128 == 0, f"W = {W} must be a positive "
             "multiple of 128")
    _require(all(t.is_contiguous() for t in (idx, val, start, x)),
             "inputs must be contiguous")
    if seg is not None:
        _require(seg.device == x.device and seg.dtype == torch.int32
                 and seg.is_contiguous()
                 and tuple(seg.shape) == (n_tiles, 4),
                 f"seg {tuple(seg.shape)} {seg.dtype} is not the extents "
                 f"of {n_tiles} tiles")
    y = x.new_empty(n_tiles * TILE)
    K = idx.shape[1] // 8
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if seg is None:
            _build.check(lib.ellw_spmv_f32(
                idx.data_ptr(), val.data_ptr(), start.data_ptr(), n_tiles,
                K, W, int(shared), x.data_ptr(), x.shape[0], y.data_ptr(),
                stream), "ellw_spmv_f32")
        else:
            _build.check(lib.ellw_spmv_trim_f32(
                idx.data_ptr(), val.data_ptr(), start.data_ptr(),
                seg.data_ptr(), n_tiles, K, W, int(shared), x.data_ptr(),
                x.shape[0], y.data_ptr(), stream),
                "ellw_spmv_trim_f32")
    return y


class EllwSpMV:
    """y = A x on the windowed ELL layout of `build_ellw` or `from_slots`
    (a dict), held on one device.

    `path` is "shared" when a window (W * 4 bytes) fits ELLW_SMEM_BYTES,
    else "read-only cache": chosen here, once, from W. `seg` holds the
    layout's `slot_extents`, built here.
    `launches` counts K6 launches; the CPU path runs the plain version
    and counts nothing."""

    def __init__(self, meta: dict, *, device):
        self.n, self.W, self.K = int(meta["n"]), int(meta["W"]), int(
            meta["K"])
        self.n_tiles, self.nnz = int(meta["n_tiles"]), int(meta["nnz"])
        if (np.asarray(meta["idx"]).min() < 0
                or np.asarray(meta["idx"]).max() >= self.W):
            raise ValueError("ellw_spmv: a slot's column lies outside its "
                             f"window of {self.W}")
        dev = torch.device(device)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        self.idx, self.val = put(meta["idx"]), put(meta["val"])
        self.start = put(meta["start"])
        seg = slot_extents(meta["idx"], meta["val"])
        self.seg = put(seg)
        self.slots_read = int(seg[:, 0].sum())  # slots a row, all tiles
        self.path = ("shared" if self.W * 4 <= ELLW_SMEM_BYTES
                     else "read-only cache")
        self.launches = 0

    @property
    def padding_waste(self) -> float:
        """Slots stored per nonzero: n_tiles * 1024 * K / nnz."""
        return self.n_tiles * TILE * self.K / self.nnz

    @property
    def read_waste(self) -> float:
        """Slots K6 reads per nonzero: 1024 * sum of the extents' T /
        nnz."""
        return TILE * self.slots_read / self.nnz

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        """The plain version on this layout, y [n]."""
        return ellw_spmv_plain(self.idx, self.val, self.start, x,
                               self.W)[:self.n]

    def raw(self, x: torch.Tensor) -> torch.Tensor:
        """K6's launch on x, uncounted: y [n_tiles * 1024]."""
        return ellw_cuda(self.idx, self.val, self.start, x, self.W,
                         self.path == "shared", self.seg)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 1 or x.shape[0] != self.n:
            raise ValueError(f"ellw_spmv: x has shape {tuple(x.shape)}, "
                             f"operator expects [{self.n}]")
        if x.device.type == "cpu":
            return self.plain(x)
        y = self.raw(x)
        self.launches += 1
        return y[:self.n]
