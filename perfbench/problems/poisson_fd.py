"""The `poisson_fd` problem: a configuration's matrix from its "grid".

A frozen, vectorised copy of the finite-difference Laplacian that the port
assembles with `lil` in `gnnla_tpu_torch/core/graph.py::laplacian_nd`
(non-periodic case), in the SPD sign convention: diagonal 2*dim,
off-diagonals -1, Dirichlet boundary. Rows are C-order grid points, and
each row's columns come out ascending, so the COO is row-sorted and
duplicate-free as it is built: no sort and no coalesce.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def poisson_fd(grid: Sequence[int]) -> Tuple[np.ndarray, np.ndarray,
                                              np.ndarray, int]:
    """(rows, cols, vals, n) of the (2*dim+1)-point FD Laplacian on `grid`
    (C order), row-sorted with ascending columns in each row; rows and
    cols int32, vals float64."""
    grid = tuple(int(g) for g in grid)
    if not grid or min(grid) < 1:
        raise ValueError(f"grid {grid}: every extent must be >= 1")
    n = int(np.prod(grid))
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows exceed int32 indices")
    dim = len(grid)
    strides = [int(np.prod(grid[a + 1:])) for a in range(dim)]
    idx = np.arange(n, dtype=np.int64)
    coords = np.unravel_index(idx, grid)
    # (offset, valid rows) per stencil point, offsets ascending: -s for the
    # largest stride first, the diagonal in the middle, then +s
    points = []
    for a in range(dim):
        points.append((-strides[a], coords[a] > 0))
    points.append((0, np.ones(n, dtype=bool)))
    for a in reversed(range(dim)):
        points.append((strides[a], coords[a] < grid[a] - 1))
    points.sort(key=lambda p: p[0])
    offs = np.array([p[0] for p in points], dtype=np.int64)
    valid = np.stack([p[1] for p in points], axis=1)        # [n, 2d+1]
    cols = idx[:, None] + offs[None, :]
    vals = np.where(offs == 0, 2.0 * dim, -1.0)[None, :].repeat(n, axis=0)
    rows = np.broadcast_to(idx[:, None], cols.shape)
    return (rows[valid].astype(np.int32), cols[valid].astype(np.int32),
            vals[valid], n)


def nnz_poisson_fd(grid: Sequence[int]) -> int:
    """Stored nonzeros of `poisson_fd(grid)`, counted from the grid."""
    grid = tuple(int(g) for g in grid)
    n = int(np.prod(grid))
    return n + sum(2 * (n // g) * (g - 1) for g in grid)


def build(config: dict):
    """The configuration's matrix as (rows, cols, vals, n)."""
    return poisson_fd(config["grid"])
