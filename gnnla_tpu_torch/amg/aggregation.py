"""Smoothed-aggregation AMG setup pieces — the counterpart of
gnnla_tpu/amg/aggregation.py (a copy: the port imports nothing of the JAX
package). Host numpy/scipy, setup phase.

The classical pipeline the reference demonstrates (CLJP/PMIS splitting +
direct interpolation, VCycle.py:94-137) is a two-grid demo; its
multilevel extension loses quality with size because independent-set
coarsening strands F-points. Smoothed aggregation (Vanek, Mandel, Brezina
1996) gives the size-independent convergence factor, with the reference's
own SA strength measure (SOCSAGNN.py:49-71 — S_ij = A_ij^2 / (A_ii A_jj)).

Vectorized numpy over edge arrays, with the sequential aggregation scan
in the native library (`native_ext.vanek_aggregate`) and the same scan in
numpy as the fallback: both give the JAX package's aggregates.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def sa_strength(A: sp.csr_matrix, theta: float) -> sp.csr_matrix:
    """Boolean SA strength: keep off-diagonal (i, j) when
    A_ij^2 >= theta^2 * |A_ii A_jj| (the SOCSAGNN measure thresholded,
    sign-robust — works for the negative-definite FD convention too)."""
    A = A.tocsr()
    d = np.abs(A.diagonal())
    d = np.where(d == 0, 1.0, d)
    C = A.tocoo()
    off = C.row != C.col
    keep = off & (C.data ** 2 >= (theta ** 2) * d[C.row] * d[C.col])
    S = sp.csr_matrix(
        (np.ones(int(keep.sum()), np.int8), (C.row[keep], C.col[keep])),
        shape=A.shape)
    S.sum_duplicates()
    return S


def aggregate(S: sp.csr_matrix, seed: int = 0) -> np.ndarray:
    """Partition nodes into aggregates over the strength graph — Vanek
    standard aggregation (Vanek/Mandel/Brezina 1996).

    Scan-order greedy, which is what packs aggregates tightly:
      pass 1: a node whose ENTIRE neighborhood is unaggregated seeds an
              aggregate of itself + its neighborhood (processed in index
              order — the dense packing this produces is worth ~2x in
              measured cycle convergence factor over random-MIS roots);
      pass 2: leftovers join the adjacent aggregate they have the most
              strong connections to (ties -> lower id), judged on the
              pass-1 state;
      pass 3: remaining nodes seed aggregates from what is left.

    The scan is sequential by nature; the C++ runtime
    (native/graphbuild.cpp::vanek_aggregate) runs it at millions of rows
    per second, with this numpy implementation as the fallback. `seed` is
    accepted for API symmetry (the algorithm is deterministic).

    Returns [n] aggregate ids (every node assigned).
    """
    del seed  # deterministic: scan order
    S = S.tocsr()
    n = S.shape[0]
    G = ((S + S.T) > 0).tocsr()  # symmetrized: aggregates ignore direction
    G.setdiag(0)
    G.eliminate_zeros()

    from gnnla_tpu_torch import native_ext
    agg = native_ext.vanek_aggregate(G)
    if agg is not None:
        return agg

    indptr, indices = G.indptr, G.indices
    agg = np.full(n, -1, dtype=np.int64)
    na = 0
    # pass 1 (sequential scan)
    for i in range(n):
        if agg[i] != -1 or indptr[i + 1] == indptr[i]:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        if np.any(agg[nbrs] != -1):
            continue
        agg[i] = na
        agg[nbrs] = na
        na += 1
    # pass 2 (vectorized: strongest adjacent aggregate by edge count,
    # ties -> lower id, judged on the pass-1 snapshot)
    un = agg == -1
    rows = np.repeat(np.arange(n), np.diff(indptr))
    cols = indices
    e = un[rows] & (agg[cols] >= 0)
    if e.any():
        ei, ea = rows[e], agg[cols[e]]
        order = np.lexsort((ea, ei))
        ei, ea = ei[order], ea[order]
        grp = np.flatnonzero(np.concatenate(
            [[True], (ei[1:] != ei[:-1]) | (ea[1:] != ea[:-1])]))
        cnt = np.diff(np.append(grp, ei.size))
        gi, ga = ei[grp], ea[grp]
        best = np.zeros(n, dtype=np.int64)
        np.maximum.at(best, gi, cnt)
        idxs = np.flatnonzero(cnt == best[gi])
        firstmask = np.concatenate([[True], gi[idxs][1:] != gi[idxs][:-1]])
        chosen = idxs[firstmask]
        agg[gi[chosen]] = ga[chosen]
    # pass 3 (sequential over the leftovers)
    for i in np.flatnonzero(agg == -1):
        if agg[i] != -1:
            continue
        agg[i] = na
        nbrs = indices[indptr[i]:indptr[i + 1]]
        free = nbrs[agg[nbrs] == -1]
        agg[free] = na
        na += 1
    return agg


def tentative_prolongator(agg: np.ndarray) -> sp.csr_matrix:
    """Piecewise-constant P_hat [n, n_agg] with unit columns (near-
    nullspace = constants: P_hat[i, agg_i] = 1/sqrt(|agg_i|))."""
    n = agg.shape[0]
    n_agg = int(agg.max()) + 1
    sizes = np.bincount(agg, minlength=n_agg).astype(np.float64)
    vals = 1.0 / np.sqrt(sizes[agg])
    return sp.csr_matrix((vals, (np.arange(n), agg)), shape=(n, n_agg))


def filtered_operator(A: sp.csr_matrix, S: sp.csr_matrix) -> sp.csr_matrix:
    """Vanek's filtered A for prolongator smoothing: weak off-diagonals
    dropped and lumped into the diagonal (preserves row sums)."""
    A = A.tocoo()
    off = A.row != A.col
    Sb = S.tocsr().astype(bool)
    strong = np.asarray(Sb[A.row, A.col]).ravel() if A.nnz else \
        np.zeros(0, bool)
    keep = ~off | strong
    lump = np.zeros(A.shape[0])
    weak = off & ~strong
    np.add.at(lump, A.row[weak], A.data[weak])
    Af = sp.csr_matrix((A.data[keep], (A.row[keep], A.col[keep])),
                       shape=A.shape)
    Af = Af + sp.diags(lump)
    return Af.tocsr()


def dinv_a_lmax(A: sp.csr_matrix, n_iters: int = 20,
                seed: int = 0) -> float:
    """lambda_max(D^-1 A) by power iteration (host, setup phase)."""
    d = A.diagonal()
    d = np.where(d == 0, 1.0, d)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(A.shape[0])
    x /= np.linalg.norm(x)
    lam = 1.0
    for _ in range(n_iters):
        y = (A @ x) / d
        nrm = np.linalg.norm(y)
        if nrm == 0:
            return 1.0
        lam = nrm
        x = y / nrm
    return float(lam)


def smoothed_prolongator(A: sp.csr_matrix, S: sp.csr_matrix,
                         P_hat: sp.csr_matrix, *,
                         omega_factor: float = 4.0 / 3.0,
                         seed: int = 0) -> sp.csr_matrix:
    """One damped-Jacobi smoothing step of the tentative prolongator:
    P = (I - omega D_f^-1 A_f) P_hat, omega = omega_factor / lmax(D_f^-1
    A_f), with A_f the weak-connection-filtered operator. This is what
    turns piecewise-constant aggregation into an O(1)-convergence-factor
    hierarchy (energy-minimizing basis functions overlap aggregates)."""
    Af = filtered_operator(A, S)
    lmax = dinv_a_lmax(Af, seed=seed)
    d = Af.diagonal()
    d = np.where(d == 0, 1.0, d)
    omega = omega_factor / max(lmax, 1e-12)
    DinvAf = sp.diags(1.0 / d) @ Af
    P = (P_hat - omega * (DinvAf @ P_hat)).tocsr()
    P.eliminate_zeros()
    return P
