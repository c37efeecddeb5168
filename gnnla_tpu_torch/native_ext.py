"""ctypes binding for the native C++ setup runtime (native/graphbuild.cpp).

The port's own binding to the same `native/libgnnla_native.so` that
gnnla_tpu.native_ext loads (importing that module would run
gnnla_tpu/__init__.py and therefore jax). Only the entry point the
two-grid slice uses is bound: CLJP splitting. When the library is
missing the numpy CLJP of amg/splitting.py runs instead — the same
fallback the JAX package takes, so both packages produce identical
coarse flags.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

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
    lib.cljp_split.restype = None
    lib.cljp_split.argtypes = [ctypes.c_int64, i64p, i64p, ctypes.c_uint64,
                               i64p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


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
