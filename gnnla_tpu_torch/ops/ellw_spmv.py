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
  * `ellw_spmv_plain` — the plain PyTorch version.
  * `ellw_cuda`       — the raw launch of K6 (`csrc/ellw_spmv.cu`).
  * `EllwSpMV`        — the wrapper: the layout on one device, `matvec`
                        (K6 on a CUDA tensor, counted in `launches`; the
                        plain version on a CPU tensor), `plain()`, and the
                        window path chosen once from W.
"""

from __future__ import annotations

import numpy as np
import torch

from gnnla_tpu_torch import _build

TILE = 1024  # rows per tile (8 lane-groups of 128)
# K6 stages a tile's window in shared memory when it takes at most this
# many bytes: the 48 KB a block may use without opting in, which leaves
# room for two 1024-thread blocks on an SM; a wider window is read
# through the read-only cache by the same kernel
ELLW_SMEM_BYTES = 48 * 1024


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
              x: torch.Tensor, W: int, shared: bool) -> torch.Tensor:
    """Launch K6: y [n_tiles * 1024] = A x for the layout idx int32, val
    f32 [n_tiles, 8K, 128], start int32 [n_tiles] and x f32 [n_x], all
    contiguous on one CUDA device; `shared` stages each window in shared
    memory, else the kernel reads x through the read-only cache."""
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
    y = x.new_empty(n_tiles * TILE)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check(lib.ellw_spmv_f32(
            idx.data_ptr(), val.data_ptr(), start.data_ptr(), n_tiles,
            idx.shape[1] // 8, W, int(shared), x.data_ptr(), x.shape[0],
            y.data_ptr(), stream), "ellw_spmv_f32")
    return y


class EllwSpMV:
    """y = A x on the windowed ELL layout of `build_ellw` or `from_slots`
    (a dict), held on one device.

    `path` is "shared" when a window (W * 4 bytes) fits ELLW_SMEM_BYTES,
    else "read-only cache": chosen here, once, from W.
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
        self.path = ("shared" if self.W * 4 <= ELLW_SMEM_BYTES
                     else "read-only cache")
        self.launches = 0

    @property
    def padding_waste(self) -> float:
        """Slots stored per nonzero: n_tiles * 1024 * K / nnz."""
        return self.n_tiles * TILE * self.K / self.nnz

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        """The plain version on this layout, y [n]."""
        return ellw_spmv_plain(self.idx, self.val, self.start, x,
                               self.W)[:self.n]

    def raw(self, x: torch.Tensor) -> torch.Tensor:
        """K6's launch on x, uncounted: y [n_tiles * 1024]."""
        return ellw_cuda(self.idx, self.val, self.start, x, self.W,
                         self.path == "shared")

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 1 or x.shape[0] != self.n:
            raise ValueError(f"ellw_spmv: x has shape {tuple(x.shape)}, "
                             f"operator expects [{self.n}]")
        if x.device.type == "cpu":
            return self.plain(x)
        y = self.raw(x)
        self.launches += 1
        return y[:self.n]
