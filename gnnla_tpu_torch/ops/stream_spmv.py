"""Kernels K2, the general-pattern SpMV, and K3, the multi-RHS SpMM — the
counterparts of gnnla_tpu/ops/pallas_stream.py's `StreamSpMV` and
`StreamSpMM`.

The JAX stream kernels compute y = A x (and Y = A X over M columns in one
pass over the matrix) on any sparsity pattern through a pack designed for
the TPU's 8x128 vector registers. On the card the same functions are the
CSR kernels `csrc/csr_spmv.cu` and `csrc/csr_spmm.cu`; their transposed
apply is the same kernel on a CSR of A^T built once at setup, as the JAX
package builds a transposed pack. The TPU's multi-RHS relayout ([t, M*8,
128] in, [t, 8, 128*M] out) has no counterpart: K3 takes the caller's
[n, M] row-major block, in the operator's (kernel) order.

  * `CsrSpMV`              — the wrapper of both: a CSR held on one
                             device, with K2's row blocks; calling it on
                             x [n] launches K2, on X [n, M] K3, for CUDA
                             tensors, and runs the plain version only for
                             CPU tensors.
                             Differentiable in x and in the values, with
                             the JAX StreamSpMV/StreamSpMM VJP (the kernel
                             on the CSR of A^T for x, sum_m ybar[row, m] *
                             x[col, m] for the values) when it is linked
                             to its transpose (`link_transposes`).
  * `csr_spmv_plain`       — the plain PyTorch version of both
                             (index_select + index_add_).
  * `csr_row_blocks`       — K2's row blocks: runs of rows whose
                             nonzeros one CUDA block stages at once,
                             warp blocks (a warp a row) and long rows;
                             `block_forms` reads which is which.
  * `check_stream_pattern` — the refusals of the JAX packer
                             (`build_stream`), so the port refuses exactly
                             the patterns the JAX package refuses and both
                             packages take the same layout.
  * `rcm_csr`              — the reverse Cuthill-McKee reordering the
                             square stream path packs in, with the JAX
                             package's choice of native or scipy order.
"""

from __future__ import annotations

import weakref
from bisect import bisect_left
from types import SimpleNamespace
from typing import Optional, Tuple

import numpy as np
import torch
from torch.autograd import profiler as _profiler

from gnnla_tpu_torch import _build
from gnnla_tpu_torch.utils.program import count, span_begin, span_end

TILE = 1024  # the JAX packer's row tile / column superchunk width
# K2's row blocks (csrc/csr_spmv.cu): nonzeros a block stages at once, rows
# a block (one a thread), the length above which a row starts a warp block
# (a warp a row, at most BLOCK_WARPS rows), and the length above which a
# row is a block of its own, summed by the whole block
BLOCK_NNZ, BLOCK_ROWS, LONG_ROW = 2048, 256, 64
WARP_ROW, BLOCK_WARPS = 256, 8

# The nonzeros of every K2 launch, and of those the warp blocks summed:
# each launch adds its CSR's `nnz` and `warp_nnz` (through `count`, so a
# graph's replays add them too)
K2_TALLY = SimpleNamespace(nnz=0, warp_nnz=0)


def check_stream_pattern(indptr, indices, n_cols: int) -> int:
    """Raise ValueError where gnnla_tpu's `build_stream` refuses a CSR
    pattern (pallas_stream.py:152-153 and :177-196; the native packer's
    status 1 is the same window test). Returns the window width in
    1024-column superchunks.

    n_cols is the width of the packed operand: for a square operator its
    side, for the square embedding of a prolongation the fine size n.
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    cols = np.asarray(indices, dtype=np.int64)
    n = indptr.shape[0] - 1
    nnz = cols.shape[0]
    if nnz == 0:
        raise ValueError("empty matrix")
    n_tiles = -(-n // TILE)
    bnd_full = indptr[np.minimum(np.arange(n_tiles + 1) * TILE, n)]
    bnd = bnd_full[:-1]
    has = bnd_full[:-1] < bnd_full[1:]
    start = np.minimum(bnd, nnz - 1)
    min_c = np.where(has, np.minimum.reduceat(cols, start), 0)
    max_c = np.where(has, np.maximum.reduceat(cols, start), 0)
    start_sc = min_c // TILE
    w_sc = int(((max_c - start_sc * TILE) // TILE + 1).max())
    lx_tiles = -(-n_cols // TILE)
    if w_sc > lx_tiles:
        raise ValueError(
            f"column window ({w_sc} superchunks) exceeds the padded vector "
            f"({lx_tiles}); matrix too small or ordering too diffuse for "
            "the stream kernel — use the COO path")
    return w_sc


def rcm_csr(A_csr):
    """(reordered CSR, permutation) via reverse Cuthill-McKee.

    The native order (`native_ext.rcm_order` + `csr_permute_sym`) when the
    library is present and the values are float32, scipy's otherwise — the
    JAX package's condition, so both packages pack the same order and
    refuse the same patterns."""
    from gnnla_tpu_torch import native_ext

    if A_csr.data.dtype == np.float32:  # native permute stores f32 values
        perm = native_ext.rcm_order(A_csr)
        if perm is not None:
            B = native_ext.csr_permute_sym(A_csr, perm)
            if B is not None:
                return B, perm
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    perm = np.asarray(reverse_cuthill_mckee(A_csr, symmetric_mode=False))
    B = A_csr[perm][:, perm].tocsr()
    B.sort_indices()
    return B, perm


def csr_spmv_plain(rows: torch.Tensor, cols: torch.Tensor,
                   vals: torch.Tensor, x: torch.Tensor,
                   n_rows: int) -> torch.Tensor:
    """K2's and K3's plain version: y[r] = sum over entries (r, c, v) of
    v * x[c], for x [n_cols] (K2) or [n_cols, M] (K3, row by row)."""
    v = vals if x.ndim == 1 else vals[:, None]
    y = x.new_zeros((n_rows,) + tuple(x.shape[1:]))
    return y.index_add_(0, rows, v * x.index_select(0, cols))


def _warp_groups(lens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(first, inside): bool [n] marks of the warp blocks' first rows and
    of every row in a warp block, for row lengths `lens`. A row of
    LONG_ROW + 1 to WARP_ROW nonzeros that no warp block holds yet starts
    one, which takes it and the rows after it up to BLOCK_WARPS in all,
    ending before a row of more than WARP_ROW."""
    n = lens.shape[0]
    mid = np.flatnonzero((lens > LONG_ROW) & (lens <= WARP_ROW)).tolist()
    huge = np.flatnonzero(lens > WARP_ROW).tolist()
    first = np.zeros(n, bool)
    edge = np.zeros(n + 1, np.int64)
    i = 0
    while i < len(mid):
        r0 = mid[i]
        r1 = min(r0 + BLOCK_WARPS, n)
        h = bisect_left(huge, r0)
        if h < len(huge):
            r1 = min(r1, huge[h])
        first[r0] = True
        edge[r0] += 1
        edge[r1] -= 1
        i = bisect_left(mid, r1, i + 1)
    return first, np.cumsum(edge[:-1]) > 0


def csr_row_blocks(row_ptr: torch.Tensor,
                   budget: int = BLOCK_NNZ) -> torch.Tensor:
    """K2's row blocks of a CSR: int32 [n_blocks + 1] row boundaries,
    increasing from 0 to n_rows, built on row_ptr's device.

    A row of more than WARP_ROW nonzeros is a block of its own (the
    kernel sums it with the whole block). A row of LONG_ROW + 1 to
    WARP_ROW nonzeros starts a warp block, up to BLOCK_WARPS rows (the
    kernel sums each with a warp; `_warp_groups`). The other rows form runs
    of consecutive rows that start in the same window of budget - LONG_ROW
    nonzeros and the same aligned run of BLOCK_ROWS rows, so a block holds
    fewer than `budget` nonzeros (its last row starts inside the window
    and holds at most LONG_ROW) and at most BLOCK_ROWS rows. Empty rows
    join their neighbours. A CSR with no row of more than LONG_ROW
    nonzeros has short-row runs alone."""
    if budget <= LONG_ROW:
        raise ValueError(f"csr_row_blocks: budget {budget} must exceed "
                         f"the long-row length {LONG_ROW}")
    rp = row_ptr.long()
    n = rp.shape[0] - 1
    with torch.no_grad():
        rows = torch.arange(n, device=rp.device)
        long_ = rp.diff() > LONG_ROW
        window = rp[:-1] // (budget - LONG_ROW)
        cut = torch.ones(n, dtype=torch.bool, device=rp.device)
        cut[1:] = (window[1:] != window[:-1]) | (rows[1:] % BLOCK_ROWS == 0)
        if bool(long_.any()):
            del window
            lens = rp.diff()
            # 0: a short row, 1: a warp block's row, 2: a row of its own
            kind = (lens > WARP_ROW).to(torch.int8) * 2
            first = torch.zeros(n, dtype=torch.bool, device=rp.device)
            if bool((long_ & (lens <= WARP_ROW)).any()):
                f, inside = _warp_groups(lens.cpu().numpy())
                first = torch.from_numpy(f).to(rp.device)
                kind[torch.from_numpy(inside).to(rp.device)] = 1
            cut[1:] = ((kind[1:] != kind[:-1]) | (kind[1:] == 2) | first[1:]
                       | ((kind[1:] == 0) & cut[1:]))
        starts = torch.nonzero(cut).reshape(-1)
        bounds = torch.cat([starts, rows.new_full((1,), n)])
    return bounds.to(torch.int32)


def block_forms(row_ptr: torch.Tensor,
                row_blocks: torch.Tensor) -> torch.Tensor:
    """The form K2 gives each row block (int64 [n_blocks]), from its first
    row as the kernel reads it: 2 the whole block (one row of more than
    WARP_ROW nonzeros), 1 a warp a row (at most BLOCK_WARPS rows, the
    first of more than LONG_ROW), 0 a thread a row."""
    starts = row_blocks[:-1].long()
    rows = row_blocks.diff()
    len0 = row_ptr[starts + 1] - row_ptr[starts] if rows.numel() else rows
    few = rows <= BLOCK_WARPS
    whole = few & (rows == 1) & (len0 > WARP_ROW)
    warp = few & ~whole & (len0 > LONG_ROW)
    return whole.long() * 2 + warp.long()


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"csr_spmv: {msg}")


def csr_spmv_cuda(row_ptr: torch.Tensor, cols: torch.Tensor,
                  vals: torch.Tensor, x: torch.Tensor, n_rows: int,
                  row_blocks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K2 (x [n_cols]) or K3 (x [n_cols, M], row-major): y = A x
    for a CSR (row_ptr [n_rows+1] int32, cols [nnz] int32, vals [nnz]
    f32) and x f32, all contiguous on one CUDA device. K2 reads the CSR's
    row blocks (`csr_row_blocks`, built here when not given)."""
    _require(x.device.type == "cuda", f"x lies on {x.device}, not CUDA")
    _require(all(t.device == x.device for t in (row_ptr, cols, vals)),
             "row_ptr, cols, vals and x must share one device")
    _require(vals.dtype == torch.float32 and x.dtype == torch.float32,
             "vals and x must be float32")
    _require(row_ptr.dtype == torch.int32 and cols.dtype == torch.int32,
             "row_ptr and cols must be int32")
    _require(x.ndim in (1, 2) and x.shape[-1] >= 1
             and row_ptr.shape == (n_rows + 1,)
             and cols.shape == vals.shape,
             f"shapes row_ptr {tuple(row_ptr.shape)}, cols "
             f"{tuple(cols.shape)}, vals {tuple(vals.shape)}, x "
             f"{tuple(x.shape)} disagree with n_rows={n_rows}")
    _require(all(t.is_contiguous() for t in (row_ptr, cols, vals, x)),
             "inputs must be contiguous")
    y = x.new_empty((n_rows,) + tuple(x.shape[1:]))
    lib = _build.load()
    args = (row_ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(), n_rows)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if x.ndim == 1:
            if row_blocks is None:
                row_blocks = csr_row_blocks(row_ptr)
            _require(row_blocks.dtype == torch.int32
                     and row_blocks.device == x.device
                     and row_blocks.ndim == 1 and row_blocks.shape[0] >= 1,
                     "row blocks must be int32 [n_blocks + 1] on x's "
                     "device")
            _build.check(lib.csr_spmv_f32(
                *args, row_blocks.data_ptr(), row_blocks.shape[0] - 1,
                cols.shape[0], x.data_ptr(), y.data_ptr(), stream),
                "csr_spmv_f32")
        else:
            _build.check(lib.csr_spmm_f32(*args, x.shape[1], x.data_ptr(),
                                          y.data_ptr(), stream),
                         "csr_spmm_f32")
    return y


def device_csr(A_csr, device: torch.device):
    """(row_ptr int32, cols int32, vals f32) of a scipy CSR on `device`."""
    if A_csr.nnz >= 2 ** 31:
        raise ValueError("csr: nnz must fit int32 row pointers")

    def put(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)

    return (put(A_csr.indptr, np.int32), put(A_csr.indices, np.int32),
            put(A_csr.data, np.float32))


def entry_rows(row_ptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """The COO row of each CSR entry, derived per call: the kernels never
    read it, so it is not kept on the device."""
    return torch.repeat_interleave(
        torch.arange(row_ptr.shape[0] - 1, device=row_ptr.device),
        torch.diff(row_ptr).long(), output_size=nnz)


NO_TRANSPOSE = "built with with_transpose=False; gradient unavailable"


class _CsrGrad(torch.autograd.Function):
    """y = A(vals) x on K2 (x [n]) or K3 (x [n, M]) with the VJP of the
    JAX `StreamSpMV.apply` / `StreamSpMM.apply` (pallas_stream.py:940-958,
    1134-1153): x's cotangent is the same kernel on the CSR of A^T (which
    keeps its own values, as the JAX transposed pack does), the values'
    sum_m ybar[row, m] * x[col, m] (:842-873, :1036-1065). Each is
    computed only when autograd asks for it, as JAX drops the unused one:
    the first Gelfand step's input is the fixed probe block."""

    @staticmethod
    def forward(ctx, x, vals, csr):
        ctx.csr = csr
        if ctx.needs_input_grad[1]:
            ctx.save_for_backward(x)
        return csr.launch(x, vals)

    @staticmethod
    def backward(ctx, ybar):
        csr = ctx.csr
        if csr.transpose is None:
            raise ValueError(NO_TRANSPOSE)
        ybar = ybar.contiguous()
        xbar = dvals = None
        if ctx.needs_input_grad[0]:
            xbar = csr.transpose.launch(ybar, csr.transpose.vals)
        if ctx.needs_input_grad[1]:
            x, = ctx.saved_tensors
            dvals = (ybar.index_select(0, entry_rows(csr.row_ptr, csr.nnz))
                     * x.index_select(0, csr.cols))
            if dvals.ndim == 2:
                dvals = dvals.sum(dim=1)
        return xbar, dvals, None


class CsrSpMV:
    """y = A x for one CSR matrix on one device, for a vector x [n_cols]
    (kernel K2) or a block X [n_cols, M] (kernel K3, the multi-RHS SpMM) —
    the wrapper of both.

    `launches` counts K2 launches and `launches_mm` K3 launches, backward
    ones included; neither moves on the CPU path, which runs the plain
    version. `transpose` is the CsrSpMV of A^T that the gradient in x runs
    on (None: no gradient, the JAX package's with_transpose=False); A's
    holds A^T's, and A^T's refers back to A's weakly (`link_transposes`).
    `row_blocks` are K2's (`csr_row_blocks`, built here once),
    `long_rows` counts the rows a whole CUDA block sums, and `warp_rows`
    and `warp_nnz` the rows and nonzeros of its warp blocks, which each
    K2 launch adds to `K2_TALLY`."""

    def __init__(self, A_csr, *, device: torch.device):
        """A_csr: scipy CSR with sorted indices (values cast to f32)."""
        self.shape: Tuple[int, int] = (int(A_csr.shape[0]),
                                       int(A_csr.shape[1]))
        self.nnz = int(A_csr.nnz)
        self.row_ptr, self.cols, self.vals = device_csr(A_csr, device)
        self.row_blocks = csr_row_blocks(self.row_ptr)
        self.long_rows = int(np.count_nonzero(np.diff(A_csr.indptr)
                                              > WARP_ROW))
        warp = block_forms(self.row_ptr, self.row_blocks) == 1
        self.warp_rows = int(self.row_blocks.diff()[warp].sum())
        self.warp_nnz = int(self.row_ptr[self.row_blocks.long()].diff()[
            warp].sum())
        self._transpose = None
        self.launches = 0
        self.launches_mm = 0

    @property
    def transpose(self) -> Optional["CsrSpMV"]:
        t = self._transpose
        return t() if isinstance(t, weakref.ref) else t

    def plain(self, x: torch.Tensor,
              vals: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The plain version on this CSR (default: the stored values)."""
        return csr_spmv_plain(entry_rows(self.row_ptr, self.nnz), self.cols,
                              self.vals if vals is None else vals, x,
                              self.shape[0])

    def launch(self, x: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        """y = A(vals) x with no autograd: the kernel on a CUDA tensor
        (counted), the plain version on a CPU tensor. K2's enqueue is the
        host-only span `k2.launch` while a profiler records."""
        if x.device.type == "cpu":
            return self.plain(x, vals)
        state = (span_begin("k2.launch", host_only=True)
                 if _profiler._is_profiler_enabled and x.ndim == 1
                 else None)
        try:
            y = csr_spmv_cuda(self.row_ptr, self.cols, vals, x,
                              self.shape[0], self.row_blocks)
            if x.ndim == 1:
                count(self, "launches")
                count(K2_TALLY, "nnz", self.nnz)
                count(K2_TALLY, "warp_nnz", self.warp_nnz)
            else:
                count(self, "launches_mm")
        finally:
            span_end(state)
        return y

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim not in (1, 2) or x.shape[0] != self.shape[1]:
            raise ValueError(f"csr_spmv: x has shape {tuple(x.shape)}, "
                             f"operator expects [{self.shape[1]}] or "
                             f"[{self.shape[1]}, M]")
        if torch.is_grad_enabled() and (x.requires_grad
                                        or self.vals.requires_grad):
            return _CsrGrad.apply(x, self.vals, self)
        return self.launch(x, self.vals)


def link_transposes(fwd: CsrSpMV, bwd: CsrSpMV) -> None:
    """Make fwd and bwd (the CSRs of A and A^T) each other's transpose,
    so each direction's gradient in x runs on the other: the mirrored VJP
    of the JAX `apply_t` (pallas_stream.py:964-980). fwd holds bwd, and
    bwd refers to fwd weakly: the pair is no reference cycle, so an
    operator that drops them frees their device memory at once, not at
    the next cyclic collection. Whoever holds bwd holds fwd too (the
    operators hold both)."""
    fwd._transpose, bwd._transpose = bwd, weakref.ref(fwd)
