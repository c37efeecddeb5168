"""Kernel K2, the general-pattern SpMV — the counterpart of
gnnla_tpu/ops/pallas_stream.py.

The JAX stream kernel computes y = A x on any sparsity pattern through a
pack designed for the TPU's 8x128 vector registers. On the card the same
function is the CSR kernel `csrc/csr_spmv.cu`; its transposed apply is
the same kernel on a CSR of A^T built once at setup, as the JAX package
builds a transposed pack.

  * `CsrSpMV`              — K2's wrapper: a CSR held on one device;
                             calling it launches the kernel on CUDA
                             tensors, and runs the plain version only for
                             CPU tensors.
  * `csr_spmv_plain`       — K2's plain PyTorch version (index_select +
                             index_add_).
  * `check_stream_pattern` — the refusals of the JAX packer
                             (`build_stream`), so the port refuses exactly
                             the patterns the JAX package refuses and both
                             packages take the same layout.
  * `rcm_csr`              — the reverse Cuthill-McKee reordering the
                             square stream path packs in, with the JAX
                             package's choice of native or scipy order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gnnla_tpu_torch import _build

TILE = 1024  # the JAX packer's row tile / column superchunk width


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
    """K2's plain version: y[r] = sum over entries (r, c, v) of v * x[c]."""
    y = x.new_zeros(n_rows)
    return y.index_add_(0, rows, vals * x.index_select(0, cols))


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"csr_spmv: {msg}")


def csr_spmv_cuda(row_ptr: torch.Tensor, cols: torch.Tensor,
                  vals: torch.Tensor, x: torch.Tensor,
                  n_rows: int) -> torch.Tensor:
    """Launch K2: y = A x for a CSR (row_ptr [n_rows+1] int32, cols [nnz]
    int32, vals [nnz] f32) and x f32, all contiguous on one CUDA device."""
    _require(x.device.type == "cuda", f"x lies on {x.device}, not CUDA")
    _require(all(t.device == x.device for t in (row_ptr, cols, vals)),
             "row_ptr, cols, vals and x must share one device")
    _require(vals.dtype == torch.float32 and x.dtype == torch.float32,
             "vals and x must be float32")
    _require(row_ptr.dtype == torch.int32 and cols.dtype == torch.int32,
             "row_ptr and cols must be int32")
    _require(x.ndim == 1 and row_ptr.shape == (n_rows + 1,)
             and cols.shape == vals.shape,
             f"shapes row_ptr {tuple(row_ptr.shape)}, cols "
             f"{tuple(cols.shape)}, vals {tuple(vals.shape)}, x "
             f"{tuple(x.shape)} disagree with n_rows={n_rows}")
    _require(all(t.is_contiguous() for t in (row_ptr, cols, vals, x)),
             "inputs must be contiguous")
    y = x.new_empty(n_rows)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check(lib.csr_spmv_f32(row_ptr.data_ptr(), cols.data_ptr(),
                                      vals.data_ptr(), n_rows, x.data_ptr(),
                                      y.data_ptr(), stream), "csr_spmv_f32")
    return y


class CsrSpMV:
    """y = A x for one CSR matrix on one device — K2's wrapper.

    `launches` counts kernel launches; it never moves on the CPU path,
    which runs the plain version."""

    def __init__(self, A_csr, *, device: torch.device):
        """A_csr: scipy CSR with sorted indices (values cast to f32)."""
        if A_csr.nnz >= 2 ** 31:
            raise ValueError("csr_spmv: nnz must fit int32 row pointers")
        indptr = np.asarray(A_csr.indptr, dtype=np.int64)
        self.shape: Tuple[int, int] = (int(A_csr.shape[0]),
                                       int(A_csr.shape[1]))
        self.nnz = int(A_csr.nnz)

        def put(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)

        self.row_ptr = put(indptr, np.int32)
        self.cols = put(A_csr.indices, np.int32)
        self.vals = put(A_csr.data, np.float32)
        self.launches = 0

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        # the COO row of each entry, derived per call: the kernel path
        # never reads it, so it is not kept on the device
        rows = torch.repeat_interleave(
            torch.arange(self.shape[0], device=self.row_ptr.device),
            torch.diff(self.row_ptr).long(), output_size=self.nnz)
        return csr_spmv_plain(rows, self.cols, self.vals, x, self.shape[0])

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 1 or x.shape[0] != self.shape[1]:
            raise ValueError(f"csr_spmv: x has shape {tuple(x.shape)}, "
                             f"operator expects [{self.shape[1]}]")
        if x.device.type == "cpu":
            return self.plain(x)
        y = csr_spmv_cuda(self.row_ptr, self.cols, self.vals, x,
                          self.shape[0])
        self.launches += 1
        return y
