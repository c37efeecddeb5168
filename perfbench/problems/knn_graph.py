"""The `knn_graph` problem: a configuration's matrix from its "points",
"k", "dims" and "seed".

A frozen copy of the JAX bench's general-graph fixture (`bench.py`:
`knn_laplacian` and the scaling of `build_general_fixture`), without its
reverse Cuthill-McKee step: the graph Laplacian of the k nearest
neighbours of uniform random points in the unit cube, edge weights
exp(-d^2 / mean(d)^2) symmetrised, over 1.01 times its largest absolute
row sum. Rows are the points' order, the order a caller hands the graph
over in; the port's operator reorders it itself.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def knn_graph(points: int, k: int, dims: int,
              seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """(rows, cols, vals, n) of the scaled k-NN Laplacian in the points'
    order, row-sorted with ascending columns in each row; rows and cols
    int32, vals float64, as the scaling leaves them."""
    import scipy.sparse as sp
    from scipy.spatial import cKDTree

    n = int(points)
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows exceed int32 indices")
    rng = np.random.default_rng(seed)
    pts = rng.random((n, int(dims)))
    d, idx = cKDTree(pts).query(pts, k=k + 1, workers=-1)
    rows = np.repeat(np.arange(n), k)
    cols = idx[:, 1:].reshape(-1)
    w = np.exp(-(d[:, 1:] ** 2) / (d[:, 1:].mean() ** 2)).reshape(-1)
    A = sp.coo_matrix((w.astype(np.float32), (rows, cols)),
                      shape=(n, n)).tocsr()
    A = A + A.T
    lap = (sp.diags(np.asarray(A.sum(axis=1)).ravel()) - A).tocsr()
    lap.sort_indices()
    lap = lap.astype(np.float32)
    lap = (lap / (abs(lap).sum(axis=1).max() * 1.01)).tocsr()
    lap.sort_indices()
    rows = np.repeat(np.arange(n, dtype=np.int32), np.diff(lap.indptr))
    return rows, lap.indices.astype(np.int32), lap.data, n


def build(config: dict):
    """The configuration's matrix as (rows, cols, vals, n)."""
    return knn_graph(config["points"], config["k"], config["dims"],
                     config["seed"])
