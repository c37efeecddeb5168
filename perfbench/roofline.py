"""Peaks of the card and the floor bytes of the work: the denominators and
numerators of every share the benchmark reports.

Frozen copy of `gnnla_tpu_torch/bench.py::bound` and its constants (the
H100 SXM's published rates, NVIDIA data sheet), corrected to count no
index bytes: an SpMV's floor is its stored values read once, x read once
and y written once, whatever format holds the pattern. Indices belong to
a format, not to the work, so a later layout that stores fewer of them
shows as a gain and not as a lower bound.
"""

from __future__ import annotations

# one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and f32 rate outside
# the tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F32 = 4


def spmv_floor_bytes(nnz: int, n_rows: int, n_cols: int = None,
                     value_bytes: int = F32) -> int:
    """Least bytes of y = A x: the stored values once, x once, y once."""
    n_cols = n_rows if n_cols is None else n_cols
    return nnz * value_bytes + n_cols * F32 + n_rows * F32


def floor_seconds(bytes_moved: float, flops: float = 0.0) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the f32 rate."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS)


def share_pct(floor_s: float, measured_s: float):
    """floor / measured in percent, or None where nothing was measured."""
    if not measured_s or measured_s <= 0 or floor_s <= 0:
        return None
    return 100.0 * floor_s / measured_s
