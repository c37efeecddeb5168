"""Device-resident sparse operators — the PyTorch counterpart of
gnnla_tpu/ops/sparse.py.

A `SparseOperator` holds row-sorted COO triplets plus CSR row pointers as
tensors on one explicit `torch.device`. Construction and every
pattern-changing operation (coalesce, diagonal removal, transpose) run on
the host in numpy, exactly as in the JAX package; the host COO triplets
are cached in float64 so the AMG setup never reads the device back.

SpMV is `index_select -> multiply -> index_add_`: the gather/scatter-add
COO path, which the JAX package runs through XLA rather than a Pallas
kernel — so plain PyTorch is this path's real implementation here too.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.ops.segment import segment_sum


class SparseOperator:
    """Square (or rectangular) sparse matrix in row-sorted COO + row pointers.

    rows, cols : int32 [nnz]       row/col per nonzero (sorted by row, then col)
    vals       : float [nnz]       nonzero values
    row_ptr    : int32 [n_rows+1]  CSR offsets
    shape      : (n_rows, n_cols)
    """

    def __init__(self, rows: torch.Tensor, cols: torch.Tensor,
                 vals: torch.Tensor, row_ptr: torch.Tensor,
                 shape: Tuple[int, int], host_coo=None):
        self.rows = rows
        self.cols = cols
        self.vals = vals
        self.row_ptr = row_ptr
        self.shape = (int(shape[0]), int(shape[1]))
        self._host_coo = host_coo
        self._row_layout = None

    # ---------------------------------------------------------------- alias
    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return self.rows.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vals.device

    # ---------------------------------------------------------- construction
    @staticmethod
    def from_coo(rows, cols, vals, shape, *, dtype=torch.float32,
                 coalesce: bool = True, device="cuda") -> "SparseOperator":
        """Build from host COO triplets (numpy or lists). Sorts by (row, col)
        and sums duplicates (the host coalesce of the JAX package)."""
        device = resolve_device(device)
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        if coalesce:
            key = rows * shape[1] + cols
            order = np.argsort(key, kind="stable")
            key, vals = key[order], vals[order]
            uniq, inverse = np.unique(key, return_inverse=True)
            summed = np.zeros(uniq.shape[0], dtype=np.float64)
            np.add.at(summed, inverse, vals)
            rows = uniq // shape[1]
            cols = uniq % shape[1]
            vals = summed
        row_ptr = np.zeros(shape[0] + 1, dtype=np.int64)
        np.add.at(row_ptr, rows + 1, 1)
        row_ptr = np.cumsum(row_ptr)
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        return SparseOperator(
            rows=torch.from_numpy(rows.astype(np.int32)).to(device),
            cols=torch.from_numpy(cols.astype(np.int32)).to(device),
            vals=torch.from_numpy(vals.astype(np_dtype)).to(device),
            row_ptr=torch.from_numpy(row_ptr.astype(np.int32)).to(device),
            shape=shape, host_coo=(rows, cols, vals))

    @staticmethod
    def from_scipy(A, *, dtype=torch.float32,
                   device="cuda") -> "SparseOperator":
        coo = A.tocoo()
        return SparseOperator.from_coo(coo.row, coo.col, coo.data, coo.shape,
                                       dtype=dtype, device=device)

    @staticmethod
    def from_dense(A, *, dtype=torch.float32, tol: float = 0.0,
                   device="cuda") -> "SparseOperator":
        """The entries of a host dense matrix with |value| > tol."""
        A = np.asarray(A)
        rows, cols = np.nonzero(np.abs(A) > tol)
        return SparseOperator.from_coo(rows, cols, A[rows, cols], A.shape,
                                       dtype=dtype, device=device)

    def _derived(self, rows, cols, vals, shape, coalesce):
        return SparseOperator.from_coo(rows, cols, vals, shape,
                                       dtype=self.vals.dtype,
                                       coalesce=coalesce, device=self.device)

    # ------------------------------------------------------------- export
    def host_coo(self):
        """(rows, cols, vals) as host numpy arrays (int64, int64, float64),
        cached at construction; read back from the device otherwise."""
        if self._host_coo is None:
            self._host_coo = (self.rows.cpu().numpy().astype(np.int64),
                              self.cols.cpu().numpy().astype(np.int64),
                              self.vals.detach().cpu().numpy().astype(
                                  np.float64))
        return self._host_coo

    def host_diagonal(self) -> np.ndarray:
        """diag(A) as a host numpy vector (setup-phase twin of diagonal())."""
        rows, cols, vals = self.host_coo()
        d = np.zeros(min(self.shape), dtype=np.float64)
        m = rows == cols
        np.add.at(d, rows[m], vals[m])
        return d

    def to_scipy(self):
        import scipy.sparse as sp
        rows, cols, vals = self.host_coo()
        return sp.coo_matrix((vals, (rows, cols)), shape=self.shape).tocsr()

    def to_dense(self) -> torch.Tensor:
        """The dense [n_rows, n_cols] matrix on the operator's device
        (duplicates summed)."""
        out = self.vals.new_zeros(self.shape)
        return out.index_put_((self.rows.long(), self.cols.long()),
                              self.vals, accumulate=True)

    # ------------------------------------------------------------- algebra
    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x for x of shape [n_cols] or [n_cols, K]."""
        if x.shape[0] != self.n_cols:
            raise ValueError(
                f"matvec: x has leading dim {x.shape[0]}, operator expects "
                f"{self.n_cols} (shape {self.shape})")
        gathered = x.index_select(0, self.cols)
        vals = self.vals if gathered.ndim == 1 else self.vals[:, None]
        return segment_sum(gathered * vals, self.rows, self.n_rows)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x)

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        """x = A^T @ y without materialising the transpose (scatter by cols)."""
        if y.shape[0] != self.n_rows:
            raise ValueError(
                f"rmatvec: y has leading dim {y.shape[0]}, operator expects "
                f"{self.n_rows} (shape {self.shape})")
        gathered = y.index_select(0, self.rows)
        vals = self.vals if gathered.ndim == 1 else self.vals[:, None]
        return segment_sum(gathered * vals, self.cols, self.n_cols)

    def sddmm(self, U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
        """Sampled dense-dense matmul: e_k = <U[rows_k], V[cols_k]>, the
        per-edge values of U @ V^T on this pattern.
        U: [n_rows, F] (or [n_rows]), V: [n_cols, F] -> [nnz]."""
        if U.ndim == 1:
            U = U[:, None]
        if V.ndim == 1:
            V = V[:, None]
        return (U.index_select(0, self.rows)
                * V.index_select(0, self.cols)).sum(dim=-1)

    def diagonal(self) -> torch.Tensor:
        """Dense diagonal vector (zeros where the diagonal is not stored)."""
        is_diag = self.rows == self.cols
        out = self.vals.new_zeros(min(self.shape))
        return out.index_add_(0, self.rows[is_diag], self.vals[is_diag])

    def with_values(self, vals) -> "SparseOperator":
        """Same pattern, new values (numpy, or a tensor, which may carry a
        gradient). Host values keep the host-COO cache; the row layout
        depends only on the pattern and always carries over."""
        host = None
        if isinstance(vals, np.ndarray):
            if self._host_coo is not None:
                host = (self._host_coo[0], self._host_coo[1],
                        np.asarray(vals, dtype=np.float64))
            vals = torch.from_numpy(np.asarray(
                vals, torch.empty((), dtype=self.vals.dtype).numpy().dtype))
        out = SparseOperator(self.rows, self.cols, vals.to(self.device),
                             self.row_ptr, self.shape, host_coo=host)
        out._row_layout = self._row_layout
        return out

    def row_layout(self):
        """The pattern's DenseRowLayout (ops/segment.py), built once from
        the host rows."""
        if self._row_layout is None:
            from gnnla_tpu_torch.ops.segment import DenseRowLayout
            self._row_layout = DenseRowLayout(self.host_coo()[0],
                                              self.n_rows)
        return self._row_layout

    def scale(self, s) -> "SparseOperator":
        """s * A; a Python scalar s keeps the host-COO cache (scaled)."""
        out = self.with_values(self.vals * s)
        if self._host_coo is not None and isinstance(s, (int, float)):
            h = self._host_coo
            out._host_coo = (h[0], h[1], h[2] * s)
        return out

    # ------------------------------------------------------- pattern views
    def remove_diagonal(self) -> "SparseOperator":
        """The operator restricted to off-diagonal entries (host-side)."""
        rows, cols, vals = self.host_coo()
        keep = rows != cols
        return self._derived(rows[keep], cols[keep], vals[keep], self.shape,
                             coalesce=False)

    def eliminate_zeros(self, tol: float = 0.0) -> "SparseOperator":
        """Drop stored entries with |value| <= tol (host-side)."""
        rows, cols, vals = self.host_coo()
        keep = np.abs(vals) > tol
        return self._derived(rows[keep], cols[keep], vals[keep], self.shape,
                             coalesce=False)

    def transpose(self) -> "SparseOperator":
        """A^T with re-sorted row-major layout (host-side setup op)."""
        rows, cols, vals = self.host_coo()
        return self._derived(cols, rows, vals,
                             (self.shape[1], self.shape[0]), coalesce=True)
