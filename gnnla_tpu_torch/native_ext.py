"""ctypes binding for the native C++ setup runtime (native/graphbuild.cpp).

The port's own binding to the same `native/libgnnla_native.so` that
gnnla_tpu.native_ext loads (importing that module would run
gnnla_tpu/__init__.py and therefore jax): COO coalescing, CSR row
pointers, CLJP splitting, RCM ordering with the symmetric CSR
permutation, and Vanek aggregation. When the library (or a symbol) is
missing the callers run numpy/scipy instead — the same fallbacks the JAX
package takes, so both packages produce identical arrays, coarse flags
and orders.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "native", "libgnnla_native.so")
_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.coalesce_coo.restype = ctypes.c_int64
    lib.coalesce_coo.argtypes = [ctypes.c_int64, i64p, i64p,
                                 ctypes.POINTER(ctypes.c_double),
                                 ctypes.c_int64]
    lib.csr_row_ptr.restype = None
    lib.csr_row_ptr.argtypes = [ctypes.c_int64, i64p, ctypes.c_int64, i64p]
    lib.cljp_split.restype = None
    lib.cljp_split.argtypes = [ctypes.c_int64, i64p, i64p, ctypes.c_uint64,
                               i64p]
    if hasattr(lib, "vanek_aggregate"):
        lib.vanek_aggregate.restype = ctypes.c_int64
        lib.vanek_aggregate.argtypes = [ctypes.c_int64, i64p, i64p, i64p]
    if hasattr(lib, "rcm_order"):
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.rcm_order.restype = None
        lib.rcm_order.argtypes = [ctypes.c_int64, i64p, i64p, i64p]
        lib.csr_permute_sym.restype = None
        lib.csr_permute_sym.argtypes = [ctypes.c_int64, i64p, i64p, f32p,
                                        i64p, i64p, i64p, f32p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def coalesce_coo(rows, cols, vals, n_cols_matrix: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort by (row, col), sum duplicates: (rows, cols, vals) as int64,
    int64, float64. Native when built, numpy else.

    The native routine rewrites its buffers in place, so copy here — callers
    keep their arrays."""
    rows = np.array(rows, dtype=np.int64, copy=True)
    cols = np.array(cols, dtype=np.int64, copy=True)
    vals = np.array(vals, dtype=np.float64, copy=True)
    lib = _load()
    if lib is not None:
        n_out = lib.coalesce_coo(
            len(rows), _i64p(rows), _i64p(cols),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            int(n_cols_matrix))
        return rows[:n_out].copy(), cols[:n_out].copy(), vals[:n_out].copy()
    # numpy fallback (the algorithm of SparseOperator.from_coo)
    key = rows * n_cols_matrix + cols
    order = np.argsort(key, kind="stable")
    key, vals = key[order], vals[order]
    uniq, inverse = np.unique(key, return_inverse=True)
    summed = np.zeros(uniq.shape[0])
    np.add.at(summed, inverse, vals)
    return uniq // n_cols_matrix, uniq % n_cols_matrix, summed


def csr_row_ptr(rows_sorted, n_rows: int) -> np.ndarray:
    """int64 [n_rows + 1] CSR offsets of row-sorted COO rows."""
    rows_sorted = np.ascontiguousarray(rows_sorted, dtype=np.int64)
    out = np.zeros(n_rows + 1, dtype=np.int64)
    lib = _load()
    if lib is not None:
        lib.csr_row_ptr(len(rows_sorted), _i64p(rows_sorted), n_rows,
                        _i64p(out))
        return out
    np.add.at(out, rows_sorted + 1, 1)
    return np.cumsum(out)


def cljp_split(S_csr, seed: int = 0) -> np.ndarray:
    """CLJP splitting; native when built, the numpy CLJP otherwise."""
    lib = _load()
    if lib is None:
        from gnnla_tpu_torch.amg.splitting import split_cljp
        return split_cljp(S_csr, seed=seed)
    import scipy.sparse as sp
    S = sp.csr_matrix(S_csr)
    n = S.shape[0]
    indptr = np.ascontiguousarray(S.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(S.indices, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    lib.cljp_split(n, _i64p(indptr), _i64p(indices),
                   ctypes.c_uint64(seed), _i64p(out))
    return out


def rcm_order(A_csr) -> Optional[np.ndarray]:
    """Reverse Cuthill-McKee permutation of a CSR matrix
    (native/graphbuild.cpp::rcm_order); None when the library or the
    symbol is missing (callers then use scipy's reverse_cuthill_mckee)."""
    lib = _load()
    if lib is None or not hasattr(lib, "rcm_order"):
        return None
    n = A_csr.shape[0]
    indptr = np.ascontiguousarray(A_csr.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A_csr.indices, dtype=np.int64)
    perm = np.zeros(n, dtype=np.int64)
    lib.rcm_order(n, _i64p(indptr), _i64p(indices), _i64p(perm))
    return perm


def csr_permute_sym(A_csr, perm):
    """B = A[perm][:, perm] with sorted indices, as a scipy CSR (float32
    values); None when the library or the symbol is missing."""
    lib = _load()
    if lib is None or not hasattr(lib, "csr_permute_sym"):
        return None
    import scipy.sparse as sp
    n = A_csr.shape[0]
    indptr = np.ascontiguousarray(A_csr.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A_csr.indices, dtype=np.int64)
    data = np.ascontiguousarray(A_csr.data, dtype=np.float32)
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    out_indptr = np.zeros(n + 1, dtype=np.int64)
    out_indices = np.zeros(indices.size, dtype=np.int64)
    out_data = np.zeros(data.size, dtype=np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.csr_permute_sym(n, _i64p(indptr), _i64p(indices),
                        data.ctypes.data_as(f32p), _i64p(perm),
                        _i64p(out_indptr), _i64p(out_indices),
                        out_data.ctypes.data_as(f32p))
    idt = np.int32 if (indices.size < 2 ** 31 and n < 2 ** 31) else np.int64
    B = sp.csr_matrix((out_data, out_indices.astype(idt),
                       out_indptr.astype(idt)), shape=A_csr.shape)
    B.has_sorted_indices = True
    return B


def vanek_aggregate(G_csr) -> Optional[np.ndarray]:
    """Sequential Vanek aggregation over a symmetrized strength graph
    (native/graphbuild.cpp::vanek_aggregate); None when the library or
    the symbol is missing (callers then run the numpy scan in
    amg/aggregation.py, which gives the same aggregates)."""
    lib = _load()
    if lib is None or not hasattr(lib, "vanek_aggregate"):
        return None
    import scipy.sparse as sp
    G = sp.csr_matrix(G_csr)
    indptr = np.ascontiguousarray(G.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(G.indices, dtype=np.int64)
    agg = np.full(G.shape[0], -1, dtype=np.int64)
    lib.vanek_aggregate(G.shape[0], _i64p(indptr), _i64p(indices),
                        _i64p(agg))
    return agg
