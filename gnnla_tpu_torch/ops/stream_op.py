"""Stream-kernel operator protocol — the counterpart of
gnnla_tpu/ops/stream_op.py.

`StreamOperator` (square) and `RectStreamOperator` (rectangular, e.g. the
AMG prolongation P) satisfy the matvec/rmatvec protocol the solvers
consume, with both directions on kernel K2 (`ops/stream_spmv.py`): matvec
on a CSR of A, rmatvec on a CSR of A^T. Both carry gradients in the
vector and in their CSR's values, as the JAX `StreamSpMV.apply`/`apply_t`
do; each direction's gradient in the vector runs K2 on the other CSR.

`stream_operator(op, reorder=True)` packs A in reverse Cuthill-McKee order
(`stream_spmv.rcm_csr`), which bounds the column windows the JAX packer
tests, and gathers caller-order vectors into kernel order and back
(`perm`/`iperm`), as the JAX package does; `reorder=False` keeps the
caller's order. Its host set-up is three stages (`stream.csr`, the host
CSR; `stream.rcm`, the ordering and its permutations; `stream.layout`,
K2's CSRs and the gathers' indices on the device), and each gather of an
apply is counted (`StreamOperator.gathers`) and, while a profiler
records, a device span `stream.perm`. `transpose=False` keeps only the
CSR of A: the multilevel cycle applies its levels forward only, and a
stored A^T of the largest such level would cost as much device memory as
A. The JAX package's
square embedding of a rectangular P was a device of the TPU pack; K2
takes the rectangular CSR directly. The embedding still decides which
patterns are refused, so both packages take the same layout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch.autograd import profiler as _profiler

from gnnla_tpu_torch.ops.sparse import SparseOperator
from gnnla_tpu_torch.ops.stream_spmv import (CsrSpMV, check_stream_pattern,
                                             link_transposes, rcm_csr)
from gnnla_tpu_torch.utils.program import count, span_begin, span_end, stage


def _vector(v: torch.Tensor, n: int, what: str) -> None:
    if v.ndim > 1:
        raise ValueError(f"stream operator {what} is vector-only")
    if v.shape[0] != n:
        raise ValueError(f"{what}: operand has {v.shape[0]} entries, "
                         f"operator expects {n}")


def csr_pair(A, device: torch.device, width: int):
    """Linked K2/K3 wrappers (`CsrSpMV`) of the host CSR A and of A^T on
    `device`, refused (ValueError) as the JAX packer would refuse the
    width x width square it packs; for a square A, width is its side."""
    At = A.T.tocsr()
    At.sort_indices()
    check_stream_pattern(A.indptr, A.indices, width)
    check_stream_pattern(At.indptr, At.indices, width)
    fwd, bwd = CsrSpMV(A, device=device), CsrSpMV(At, device=device)
    link_transposes(fwd, bwd)
    return fwd, bwd


def _host_csr(op: SparseOperator, shape: Tuple[int, int]):
    import scipy.sparse as sp

    rows, cols, vals = op.host_coo()
    if cols.size and cols.max() >= shape[1]:
        raise ValueError(f"operator has columns beyond n_cols={shape[1]}")
    A = sp.csr_matrix((vals, (rows, cols)), shape=shape)
    A.sort_indices()
    return A


class StreamOperator:
    """Square sparse operator on kernel K2 (matvec, rmatvec, diagonal).

    fwd / bwd    : K2 on the kernel-order CSR of A and of A^T; bwd None for
                   a forward-only operator, whose rmatvec and gradient in x
                   raise
    perm / iperm : caller order <-> kernel (RCM) order gathers, or None
    diag         : [n] diagonal in caller order
    gathers      : the caller-order gathers run (two an apply with perm)"""

    def __init__(self, fwd: CsrSpMV, bwd: Optional[CsrSpMV],
                 diag: torch.Tensor,
                 perm: Optional[torch.Tensor] = None,
                 iperm: Optional[torch.Tensor] = None):
        self.fwd = fwd
        self.bwd = bwd
        self.diag = diag
        self.perm = perm
        self.iperm = iperm
        self.shape: Tuple[int, int] = fwd.shape
        self.nnz = fwd.nnz
        self.gathers = 0

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    def _gather(self, v: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
        """v[index], one caller-order gather: counted, and a device span
        `stream.perm` while a profiler records."""
        state = (span_begin("stream.perm") if _profiler._is_profiler_enabled
                 else None)
        try:
            out = v[index]
        finally:
            span_end(state)
        count(self, "gathers")
        return out

    def _apply(self, kernel: CsrSpMV, v: torch.Tensor) -> torch.Tensor:
        if self.perm is None:
            return kernel(v)
        return self._gather(kernel(self._gather(v, self.perm)), self.iperm)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        _vector(x, self.n_cols, "matvec")
        return self._apply(self.fwd, x)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x)

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        """A^T y (K2 on the transposed CSR; B^T = P A^T P^T)."""
        if self.bwd is None:
            raise ValueError("rmatvec: this stream operator was built "
                             "forward-only (transpose=False) and holds no "
                             "CSR of A^T")
        _vector(y, self.n_rows, "rmatvec")
        return self._apply(self.bwd, y)

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
    fwd, bwd = csr_pair(_host_csr(op, (n, int(n_cols))), op.device,
                        width=n)
    return RectStreamOperator(fwd, bwd)


def stream_operator(op: SparseOperator, *, reorder: bool = True,
                    transpose: bool = True) -> StreamOperator:
    """Build a StreamOperator from a square SparseOperator (host setup).

    `reorder=True` packs the RCM-permuted operator (results stay in caller
    order through the perm/iperm gathers); `reorder=False` packs the
    caller's order, which must already have bounded column windows.
    `transpose=False` builds the CSR of A alone (no rmatvec, no gradient
    in x). ValueError where the JAX packer refuses the packed pattern."""
    if op.shape[0] != op.shape[1]:
        raise ValueError("stream SpMV requires a square operator")
    with stage("stream.csr"):
        A = _host_csr(op, op.shape)
    p = None
    if reorder:
        with stage("stream.rcm"):
            A, p = rcm_csr(A)
            ip = np.argsort(p)
    with stage("stream.layout"):
        perm = iperm = None
        if p is not None:
            perm = torch.from_numpy(p.astype(np.int64)).to(op.device)
            iperm = torch.from_numpy(ip.astype(np.int64)).to(op.device)
        if transpose:
            fwd, bwd = csr_pair(A, op.device, width=op.n_rows)
        else:
            check_stream_pattern(A.indptr, A.indices, op.n_rows)
            fwd, bwd = CsrSpMV(A, device=op.device), None
        diag = torch.from_numpy(op.host_diagonal().astype(np.float32)).to(
            op.device)
    return StreamOperator(fwd, bwd, diag, perm, iperm)
