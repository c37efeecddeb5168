"""Coarse/fine splitting for AMG — the counterpart of
gnnla_tpu/amg/splitting.py (a copy: the port imports nothing of the JAX
package). Replaces pyamg's native CLJP.

The reference calls pyamg's C++ `CLJP` splitting (DirectInterpGNN.py:178,194;
VCycle.py:46,114); the MATLAB variant shows that a trivial alternating
splitting is also acceptable for the oracle tests (test_vcycle.m:66-67,
test_direct_interpolation.m:64-65).

These are irregular, data-dependent host algorithms, so (like the reference)
they run host-side in numpy during the AMG *setup* phase, seeded for
reproducibility. Three splittings:

  * `split_alternating` — C = every other point (MATLAB parity fixture)
  * `split_pmis`        — parallel modified independent set (Sterck/Yang/Heys)
  * `split_cljp`        — Cleary-Luby-Jones-Plassmann with both edge-removal
                          heuristics (the reference's default)

Input is the boolean strength matrix S (S[i, j] True when j strongly
influences i, i.e. edge i->j is strong) as scipy CSR; output is an int array
with 1 = coarse, 0 = fine.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

UNDECIDED, FINE, COARSE = -1, 0, 1


def split_alternating(n: int) -> np.ndarray:
    out = np.zeros(n, dtype=np.int64)
    out[::2] = 1
    return out


def _strength_csr(S) -> sp.csr_matrix:
    S = sp.csr_matrix(S, copy=True)
    S.data = (S.data != 0).astype(np.int8)
    S.eliminate_zeros()
    S.setdiag(0)
    S.eliminate_zeros()
    return S


def split_pmis(S, seed: int = 0) -> np.ndarray:
    """PMIS: weights |S^T_i| + rand; iteratively pick distance-1 independent
    local maxima as C, mark their strong neighbors F.

    Fully vectorized over the strength graph — each round is a handful of
    O(nnz) sparse passes (the round count is the independent-set depth,
    ~O(log n)), so million-row setups take seconds, matching the role of
    pyamg's native splittings in the reference (VCycle.py:114)."""
    S = _strength_csr(S)
    n = S.shape[0]
    rng = np.random.default_rng(seed)
    influence = np.asarray(S.sum(axis=0)).ravel()  # |S^T_i|
    w = influence + rng.random(n)                  # strictly positive
    state = np.full(n, UNDECIDED, dtype=np.int64)
    state[(influence == 0) & (np.asarray(S.sum(axis=1)).ravel() == 0)] = FINE

    G = ((S + S.T) > 0).astype(np.int8).tocsr()  # symmetrised strength graph
    rows = np.repeat(np.arange(n), np.diff(G.indptr))
    cols = G.indices

    while np.any(state == UNDECIDED):
        active = state == UNDECIDED
        w_active = np.where(active, w, 0.0)
        # per-row max of active neighbor weights, one vectorized pass
        neigh_max = np.zeros(n)
        np.maximum.at(neigh_max, rows, w_active[cols])
        new_c = active & (w_active > neigh_max)
        if not np.any(new_c):  # isolated undecided points
            state[active] = FINE
            break
        state[new_c] = COARSE
        # strong neighbors of new C points become F
        touched = new_c[rows]
        nbrs = cols[touched]
        state[nbrs[state[nbrs] == UNDECIDED]] = FINE
    state[state == UNDECIDED] = FINE
    return (state == COARSE).astype(np.int64)


def split_cljp(S, seed: int = 0) -> np.ndarray:
    """CLJP splitting with the two classic edge-removal heuristics.

    H1: once c is C, values at c are not interpolated, so edges c->j lose
        value: remove them and decrement w(j).
    H2: if i and j both strongly depend on a common new C point and j also
        influences i, j is less valuable to i: remove edge i->j, decrement w(j).
    Any undecided point whose remaining weight < 1 becomes F.

    Fully vectorized over edge arrays: each round is a handful of O(nnz)
    numpy passes plus one sparse P @ P^T for the common-new-C-dependency
    test of H2 (P = live dependencies on this round's C points), so the
    pure-Python fallback stays usable at million-row setup scale when the
    C++ runtime (native/graphbuild.cpp) isn't built. Within a round the
    removals are applied simultaneously from the round-start edge set —
    the standard formulation; the sequential-update variant differs only
    in tie-breaking and both yield valid splittings.
    """
    S = _strength_csr(S).tocoo()
    n = S.shape[0]
    rng = np.random.default_rng(seed)
    ei = S.row.astype(np.int64)   # edge i -> j: i strongly depends on j
    ej = S.col.astype(np.int64)
    live = np.ones(ei.size, dtype=bool)

    # weight = how many points depend on j (|S^T_j|) + tie-break noise
    w = np.bincount(ej, minlength=n).astype(np.float64) + rng.random(n)
    state = np.full(n, UNDECIDED, dtype=np.int64)
    touched = np.zeros(n, dtype=bool)
    touched[ei] = True
    touched[ej] = True
    state[~touched] = FINE        # isolated points

    while np.any(state == UNDECIDED):
        undec = state == UNDECIDED
        # independent set: undecided local maxima of w over live edges
        w_active = np.where(undec, w, 0.0)
        neigh_max = np.zeros(n)
        li, lj = ei[live], ej[live]
        np.maximum.at(neigh_max, li, w_active[lj])
        np.maximum.at(neigh_max, lj, w_active[li])
        new_c = undec & (w_active > neigh_max)
        if not np.any(new_c):
            state[undec] = FINE
            break
        state[new_c] = COARSE

        # H1: edges c -> j with c newly C
        h1 = live & new_c[ei]
        # i -> c edges: removed, no weight change (c already decided)
        ic = live & new_c[ej]
        # H2: remaining live edges (i, j) where i and j share a new-C
        # dependency. P[i, c] = live edge i -> c (c new); the shared-dep
        # test is (P @ P^T)[i, j] > 0 evaluated only on candidate edges.
        h2 = np.zeros_like(live)
        cand = live & ~h1 & ~ic
        if np.any(ic) and np.any(cand):
            P = sp.csr_matrix(
                (np.ones(int(ic.sum()), np.int8), (ei[ic], ej[ic])),
                shape=(n, n))
            M = (P @ P.T).tocsr()
            if M.nnz:
                idx = np.flatnonzero(cand)
                common = np.asarray(
                    M[ei[idx], ej[idx]]).ravel() > 0
                h2[idx[common]] = True

        # weight decrements: each removed h1/h2 edge * -> j costs j one
        # dependent, only while j is still undecided
        dec = ej[h1 | h2]
        dec = dec[state[dec] == UNDECIDED]
        np.add.at(w, dec, -1.0)
        live &= ~(h1 | h2 | ic)

        # F assignment: weight fell below 1
        state[(state == UNDECIDED) & (w < 1.0)] = FINE
    state[state == UNDECIDED] = FINE
    return (state == COARSE).astype(np.int64)


_SPLITTERS = {
    "alternating": lambda S, seed=0: split_alternating(S.shape[0]),
    "pmis": split_pmis,
    "cljp": split_cljp,
}


def split(S, method: str = "cljp", seed: int = 0) -> np.ndarray:
    if method == "cljp":
        # prefer the C++ runtime when built (native/graphbuild.cpp) — same
        # role pyamg's native CLJP plays for the reference (VCycle.py:114)
        from gnnla_tpu_torch import native_ext
        if native_ext.available():
            return native_ext.cljp_split(S, seed=seed)
    try:
        fn = _SPLITTERS[method]
    except KeyError:
        raise ValueError(f"unknown splitting {method!r}") from None
    return fn(S, seed=seed)
