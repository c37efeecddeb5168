"""Stream-kernel operator protocol — the counterpart of
gnnla_tpu/ops/stream_op.py.

`StreamOperator` (square) and `RectStreamOperator` (rectangular, e.g. the
AMG prolongation P) satisfy the matvec/rmatvec protocol the solvers
consume, with both directions on kernel K2 (`ops/stream_spmv.py`): matvec
on a CSR of A, rmatvec on a CSR of A^T.

Only `reorder=False` is ported: the caller's order is the kernel's order.
The RCM path (`rcm_csr`, `setup_with_stream`) comes with a later slice.
The JAX package's square embedding of a rectangular P was a device of the
TPU pack; K2 takes the rectangular CSR directly. The embedding still
decides which patterns are refused, so both packages take the same layout.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gnnla_tpu_torch.ops.sparse import SparseOperator
from gnnla_tpu_torch.ops.stream_spmv import CsrSpMV, check_stream_pattern


def _vector(v: torch.Tensor, n: int, what: str) -> None:
    if v.ndim > 1:
        raise ValueError(f"stream operator {what} is vector-only")
    if v.shape[0] != n:
        raise ValueError(f"{what}: operand has {v.shape[0]} entries, "
                         f"operator expects {n}")


def _csr_pair(op: SparseOperator, shape: Tuple[int, int], width: int):
    """Host CSRs of A and A^T for `shape`, refused as the JAX packer would
    refuse the width x width square it packs."""
    import scipy.sparse as sp

    rows, cols, vals = op.host_coo()
    if cols.size and cols.max() >= shape[1]:
        raise ValueError(f"operator has columns beyond n_cols={shape[1]}")
    A = sp.csr_matrix((vals, (rows, cols)), shape=shape)
    A.sort_indices()
    At = A.T.tocsr()
    At.sort_indices()
    check_stream_pattern(A.indptr, A.indices, width)
    check_stream_pattern(At.indptr, At.indices, width)
    return CsrSpMV(A, device=op.device), CsrSpMV(At, device=op.device)


class StreamOperator:
    """Square sparse operator on kernel K2 (matvec, rmatvec, diagonal)."""

    def __init__(self, fwd: CsrSpMV, bwd: CsrSpMV, diag: torch.Tensor):
        self.fwd = fwd
        self.bwd = bwd
        self.diag = diag
        self.shape: Tuple[int, int] = fwd.shape
        self.nnz = fwd.nnz

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        _vector(x, self.n_cols, "matvec")
        return self.fwd(x)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x)

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        _vector(y, self.n_rows, "rmatvec")
        return self.bwd(y)

    def diagonal(self) -> torch.Tensor:
        return self.diag


class RectStreamOperator:
    """[n x nc] operator on kernel K2.

    matvec  : [nc] -> [n]   (P apply, CSR of P)
    rmatvec : [n] -> [nc]   (P^T apply, CSR of P^T)
    """

    def __init__(self, fwd: CsrSpMV, bwd: CsrSpMV):
        self.fwd = fwd
        self.bwd = bwd
        self.shape: Tuple[int, int] = fwd.shape
        self.nnz = fwd.nnz

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        _vector(x, self.n_cols, "rect stream matvec")
        return self.fwd(x)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x)

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        _vector(y, self.n_rows, "rect stream rmatvec")
        return self.bwd(y)


def rect_stream_operator(op: SparseOperator,
                         n_cols: int) -> RectStreamOperator:
    """The K2 twin of an [n x n_cols] operator, given either as an
    [n x n_cols] SparseOperator or as the n x n square embedding the JAX
    package packs (columns >= n_cols empty). No reordering: the pattern
    must already have bounded per-tile column windows; ValueError
    otherwise, and callers keep the COO path."""
    n = op.n_rows
    if op.n_cols not in (n, n_cols):
        raise ValueError(f"expected an [{n} x {n_cols}] operator or its "
                         f"[{n} x {n}] square embedding, got {op.shape}")
    fwd, bwd = _csr_pair(op, (n, int(n_cols)), width=n)
    return RectStreamOperator(fwd, bwd)


def stream_operator(op: SparseOperator) -> StreamOperator:
    """Build a StreamOperator from a square SparseOperator (host setup), in
    the caller's order — the JAX package's `reorder=False`."""
    if op.shape[0] != op.shape[1]:
        raise ValueError("stream SpMV requires a square operator")
    fwd, bwd = _csr_pair(op, op.shape, width=op.n_rows)
    diag = torch.from_numpy(op.host_diagonal().astype(np.float32)).to(
        op.device)
    return StreamOperator(fwd, bwd, diag)
