"""K2 on an unstructured graph: correctness, VJP and throughput — the twin
of scratch/bench_stream.py.

    python -m gnnla_tpu_torch.scratch.bench_stream [N] [--cpu]

The fixture is the script's: the k-NN-32 graph Laplacian of N scattered
points (default 1,048,576; numpy seed 7), the sparsity of meshfree and
RBF-FD discretizations, scaled to a row sum below 1 and put in reverse
Cuthill-McKee order. K2 (`ops/stream_spmv.py`, `csrc/csr_spmv.cu`) must
agree with its plain version and with scipy to 1e-5 (relative to max|y|),
its VJP with 2 A^T (A x) to 1e-4; then edges/s over 5 chains of 100
applies, and the rate of scipy on the host beside it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gnnla_tpu_torch.ops.stream_spmv import CsrSpMV, link_transposes, rcm_csr
from gnnla_tpu_torch.scratch._common import (device, parser, say, sync,
                                             where)

N_DEFAULT = 1 << 20


def knn_laplacian(n: int, k: int = 32, seed: int = 7):
    """The k-NN graph Laplacian of n random points (bench_stream.py:12-26):
    edge weights exp(-d^2 / mean(d)^2), symmetrized, float32 CSR. The
    neighbour query runs on every core (the script's runs on one); its
    result does not depend on that."""
    import scipy.sparse as sp
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    tree = cKDTree(pts)
    d, idx = tree.query(pts, k=k + 1, workers=-1)  # the same, on all cores
    rows = np.repeat(np.arange(n), k)
    cols = idx[:, 1:].reshape(-1)
    w = np.exp(-(d[:, 1:] ** 2) / (d[:, 1:].mean() ** 2)).reshape(-1)
    A = sp.coo_matrix((w.astype(np.float32), (rows, cols)),
                      shape=(n, n)).tocsr()
    A = A + A.T
    lap = (sp.diags(np.asarray(A.sum(axis=1)).ravel()) - A).tocsr()
    lap.sort_indices()
    return lap.astype(np.float32)


def fixture(n: int):
    """The script's operator (bench_stream.py:40-43): the k-NN-32
    Laplacian over 1.01 times its largest absolute row sum, in RCM order
    (float64, as the division leaves it)."""
    lap = knn_laplacian(n)
    lap = (lap / (abs(lap).sum(axis=1).max() * 1.01)).tocsr()
    lap.sort_indices()
    A, _ = rcm_csr(lap)
    return A


def run(A, dev: torch.device, *, n_iters: int = 100, n_chain: int = 5,
        verbose: bool = True) -> dict:
    """K2 (with its transpose linked, for the VJP) on the CSR A: errors,
    the VJP, edges/s over n_chain chains of n_iters applies, scipy's rate.
    K2 launches: 1 (check) + 1 (VJP forward) + n_iters * (n_chain + 1)
    on A and 1 (VJP backward) on A^T."""
    n = A.shape[0]
    t0 = time.perf_counter()
    mv = CsrSpMV(A, device=dev)
    mt = CsrSpMV(A.T.tocsr(), device=dev)
    link_transposes(mv, mt)
    build_s = time.perf_counter() - t0
    if verbose:
        say(f"build {build_s:.1f}s rows={n} nnz={A.nnz} "
            f"row_blocks={mv.row_blocks.shape[0] - 1} "
            f"warp_rows={mv.warp_rows} long_rows={mv.long_rows} "
            f"(device {dev})")
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n).astype(np.float32)
    xt = torch.from_numpy(x).to(dev)
    y = mv(xt)
    plain = mv.plain(xt)
    err_plain = float((y - plain).abs().max() / plain.abs().max())
    expect = A @ x
    err = float(np.abs(y.cpu().numpy() - expect).max()
                / np.abs(expect).max())
    if verbose:
        say(f"on-chip rel err: {err:.2e} (scipy), {err_plain:.2e} (plain "
            "version)")
    if not (err < 1e-5 and err_plain < 1e-5):
        raise AssertionError(f"bench_stream: MISMATCH {err:.2e}, "
                             f"{err_plain:.2e}")

    x3 = torch.ones(n, device=dev)
    for _ in range(n_iters):  # one chain to warm up
        x3 = mv(x3)
    sync(dev)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    for _ in range(n_chain):
        for _ in range(n_iters):
            x3 = mv(x3)
    if dev.type == "cuda":
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) * 1e-3
    else:
        dt = time.perf_counter() - t0
    s = float(x3.sum())
    if not np.isfinite(s):
        raise AssertionError(f"bench_stream: chained applies gave {s}")
    eps = A.nnz * n_iters * n_chain / dt
    ms = dt / (n_iters * n_chain) * 1e3
    if verbose:
        say(f"stream spmv: {eps:.3e} edges/s  ({dt:.3f}s, {ms:.3f} ms/mv, "
            f"{where(dev)})")

    xg = torch.from_numpy(x).to(dev).requires_grad_(True)
    (mv(xg) ** 2).sum().backward()
    gx = xg.grad.cpu().numpy()
    expect_g = 2 * (A.T @ (A @ x))
    gerr = float(np.abs(gx - expect_g).max() / np.abs(expect_g).max())
    if verbose:
        say(f"vjp rel err: {gerr:.2e}")
    if not gerr < 1e-4:
        raise AssertionError(f"bench_stream: VJP rel err {gerr:.2e}")

    xx = x.copy()
    t0 = time.perf_counter()
    for _ in range(20):
        xx = A @ xx
    cpu = A.nnz * 20 / (time.perf_counter() - t0)
    if verbose:
        say(f"cpu scipy:   {cpu:.3e} edges/s  (ratio {eps / cpu:.1f}x)")
    return dict(op=mv, op_t=mt, x=xt, y=y, build_s=build_s, rel_err=err,
                rel_err_plain=err_plain, vjp_rel_err=gerr,
                edges_per_s=eps, ms_per_apply=ms, scipy_edges_per_s=cpu,
                ratio=eps / cpu)


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("n", nargs="?", type=int, default=N_DEFAULT)
    args = p.parse_args(argv)
    dev = device(args)
    t0 = time.perf_counter()
    A = fixture(args.n)
    say(f"fixture {time.perf_counter() - t0:.1f}s nnz={A.nnz}")
    return run(A, dev)


if __name__ == "__main__":
    main()
