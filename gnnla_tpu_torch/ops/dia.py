"""DIA (diagonal) sparse format — the PyTorch counterpart of
gnnla_tpu/ops/dia.py.

    y = sum_k  diags[k] * shift(x, offsets[k])

`dia_matvec` (the shifted-slice loop behind `DIAOperator.matvec`) is the
plain PyTorch version of kernel K1, the hand-written CUDA DIA SpMV in
`ops/dia_spmv.py`; `dia_transpose` gives A^T's diagonals, on which K1's
backward runs. Conversion from `SparseOperator` is a host-side setup op,
as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gnnla_tpu_torch.ops.sparse import SparseOperator


def dia_matvec(diags: torch.Tensor, offsets: Tuple[int, ...],
               x: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_k diags[k, i] * x[i + offsets[k]] over in-range columns,
    accumulated in k order. diags is [K, N] with x [N] or [N, m], or a
    batch of operators [B, K, N] with x [B, N] or [B, N, m] (the JAX
    package's vmap over B, written out). Differentiable in diags and x."""
    nb = diags.ndim - 2  # batch dims
    n = diags.shape[-1]
    if (x.ndim not in (nb + 1, nb + 2) or x.shape[:nb] != diags.shape[:nb]
            or x.shape[nb] != n):
        raise ValueError(f"matvec: x {tuple(x.shape)} does not fit "
                         f"diagonals {tuple(diags.shape)}")

    def col(d):
        return d if x.ndim == nb + 1 else d[..., None]

    y = torch.zeros_like(x)
    for k, off in enumerate(offsets):
        d = col(diags[..., k, :])
        m = n - abs(off)
        if off == 0:
            y = y + d * x
        elif m > 0:
            # row i uses x[i + off] for the rows where i + off is in range
            lo, src = (0, off) if off > 0 else (-off, 0)
            y.narrow(nb, lo, m).add_(d.narrow(nb, lo, m)
                                     * x.narrow(nb, src, m))
    return y


class DIAOperator:
    """Square banded operator: diags[k, i] = A[i, i + offsets[k]].

    diags   : [K, N] tensor; entry (k, i) multiplies x[i + off_k]
    offsets : tuple of K ints (sorted)
    nnz     : true nonzero count of the source pattern (the dense [K, N]
              storage also holds structural zeros at band boundaries)
    """

    def __init__(self, diags: torch.Tensor, offsets: Tuple[int, ...],
                 n: int, nnz: int = 0):
        self.diags = diags
        self.offsets = tuple(int(o) for o in offsets)
        self.n = int(n)
        self.nnz = int(nnz)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x with shifted contiguous reads (no gather)."""
        return dia_matvec(self.diags, self.offsets, x)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x)

    def diagonal(self) -> torch.Tensor:
        return self.diags[self.offsets.index(0)]


def dia_transpose(dia: DIAOperator) -> DIAOperator:
    """A^T in DIA form: AT_diag[offset m][i] = A_diag[offset -m][i + m].

    Pure shifts of the stored diagonals (exact in any dtype): the x
    cotangent of y = A x is A^T ybar, itself a DIA SpMV (kernel K1)."""
    new_offsets = tuple(-o for o in reversed(dia.offsets))
    rows = []
    for m in new_offsets:
        src = dia.diags[dia.offsets.index(-m)]
        pad = src.new_zeros(min(abs(m), dia.n))
        if m == 0:
            rows.append(src)
        elif m > 0:
            rows.append(torch.cat([src[m:], pad]))
        else:
            rows.append(torch.cat([pad, src[:m]]))
    return DIAOperator(diags=torch.stack(rows), offsets=new_offsets,
                       n=dia.n, nnz=dia.nnz)


def to_dia(op: SparseOperator,
           max_offsets: Optional[int] = 4096) -> DIAOperator:
    """Convert a banded SparseOperator to DIA (host-side setup), on the
    operator's device.

    Raises ValueError when the pattern has more distinct offsets than
    `max_offsets` (then the COO path is the right one).
    """
    if op.shape[0] != op.shape[1]:
        raise ValueError("DIA requires a square operator")
    n = op.shape[0]
    rows, cols, vals = op.host_coo()
    offs = cols - rows
    uniq = np.unique(offs)
    if max_offsets is not None and uniq.size > max_offsets:
        raise ValueError(f"pattern has {uniq.size} diagonal offsets "
                         f"(> {max_offsets}); not banded enough for DIA")
    diags = np.zeros((uniq.size, n), dtype=np.float64)
    k_idx = np.searchsorted(uniq, offs)
    np.add.at(diags, (k_idx, rows), vals)
    diags_t = torch.from_numpy(diags).to(op.vals.dtype).to(op.device)
    return DIAOperator(diags=diags_t, offsets=tuple(int(o) for o in uniq),
                       n=n, nnz=op.nnz)
