"""The windowed ELL SpMV on a general graph — the twin of
scratch/proto_ellw.py, on kernel K6 (`ops/ellw_spmv.py`,
`csrc/ellw_spmv.cu`).

    python -m gnnla_tpu_torch.scratch.proto_ellw [--n N] [--cpu]

The fixture is the script's: the graph Laplacian of the Delaunay
triangulation of n random points (numpy seed 7) in reverse Cuthill-McKee
order, float32. Prints the layout (K, W, tiles, nnz), the window path,
the error against scipy (which must stay below 1e-5 of max|y|), ms per
launch and edges/s.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gnnla_tpu_torch.ops.ellw_spmv import EllwSpMV, build_ellw
from gnnla_tpu_torch.scratch._common import (device, ms_per_call, parser,
                                             say, where)

N_DEFAULT = 1 << 14


def delaunay_laplacian(n: int, rng: np.random.Generator):
    """The graph Laplacian (float64 CSR, natural order) of the Delaunay
    triangulation of n points drawn from `rng` (proto_ellw.py:139-153)."""
    import scipy.sparse as sp
    from scipy.spatial import Delaunay

    pts = rng.random((n, 2))
    s = Delaunay(pts).simplices
    e = np.concatenate([s[:, [0, 1]], s[:, [1, 2]], s[:, [2, 0]]])
    e = np.concatenate([e, e[:, ::-1]])
    A = sp.coo_matrix((np.ones(e.shape[0]), (e[:, 0], e[:, 1])),
                      shape=(n, n)).tocsr()
    A.data[:] = 1.0
    A = A + A.T
    A.data[:] = -1.0
    return sp.diags(np.asarray(-A.sum(axis=1)).ravel()) + A


def rcm_ordered(lap):
    """`lap` in scipy's symmetric reverse Cuthill-McKee order, float32,
    columns sorted (proto_ellw.py:154-157)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    perm = reverse_cuthill_mckee(lap.tocsr(), symmetric_mode=True)
    out = lap.tocsr()[perm][:, perm].tocsr()
    out.sort_indices()
    return out.astype(np.float32)


def run(lap, x: np.ndarray, dev: torch.device, *, iters: int = 20,
        verbose: bool = True) -> dict:
    """Build the layout of the CSR `lap`, run K6 on x (the plain version
    on the CPU) and hold it against scipy, then time it: 2 + iters
    launches in all. Returns the operator, y and the numbers printed."""
    t0 = time.perf_counter()
    meta = build_ellw(lap)
    setup_s = time.perf_counter() - t0
    op = EllwSpMV(meta, device=dev)
    if verbose:
        say(f"setup {setup_s:.2f}s  K={meta['K']} W={meta['W']} "
            f"tiles={meta['n_tiles']} nnz={meta['nnz']} "
            f"window path: {op.path} (device {dev})")
    xt = torch.from_numpy(x).to(dev)
    y = op.matvec(xt)
    expect = lap @ x
    err = float(np.abs(y.cpu().numpy() - expect).max()
                / (np.abs(expect).max() + 1e-30))
    if verbose:
        say(f"rel err: {err:.3e}")
    if not err < 1e-5:
        raise AssertionError(f"proto_ellw: rel err {err:.3e} >= 1e-5")
    ms = ms_per_call(lambda: op.matvec(xt), dev, iters)
    eps = meta["nnz"] / (ms * 1e-3)
    if verbose:
        say(f"ellw spmv: {eps:.3e} edges/s  ({ms:.4f} ms per launch, "
            f"{where(dev)})")
    return dict(op=op, meta=meta, x=xt, y=y, setup_s=setup_s, rel_err=err,
                ms=ms, edges_per_s=eps)


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--n", type=int, default=N_DEFAULT)
    args = p.parse_args(argv)
    dev = device(args)
    rng = np.random.default_rng(7)
    lap = rcm_ordered(delaunay_laplacian(args.n, rng))
    x = rng.standard_normal(lap.shape[0]).astype(np.float32)
    return run(lap, x, dev)


if __name__ == "__main__":
    main()
