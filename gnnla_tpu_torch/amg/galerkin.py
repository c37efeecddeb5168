"""Galerkin triple product Ac = P^T A P — the counterpart of
gnnla_tpu/amg/galerkin.py. A pattern-changing SpGEMM, so it belongs to
the host-side AMG setup; scipy's native SpGEMM does the work on the
float64 host COO, and Ac lands on A's device."""

from __future__ import annotations

from gnnla_tpu_torch.ops.sparse import SparseOperator


def galerkin_product(A: SparseOperator, P: SparseOperator,
                     *, dtype=None) -> SparseOperator:
    dtype = dtype or A.vals.dtype
    A_h = A.to_scipy()
    P_h = P.to_scipy()
    Ac = (P_h.T @ A_h @ P_h).tocsr()
    # canonical in scipy (sorted, no duplicates), so from_coo can skip
    # its global coalesce pass
    Ac.sum_duplicates()
    Ac.sort_indices()
    Ac = Ac.tocoo()
    return SparseOperator.from_coo(Ac.row, Ac.col, Ac.data, Ac.shape,
                                   dtype=dtype, coalesce=False,
                                   device=A.device)
