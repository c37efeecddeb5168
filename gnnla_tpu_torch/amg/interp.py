"""Sparse prolongation assembly: P = (I + W)[:, coarse] — the counterpart
of gnnla_tpu/amg/interp.py.

  * every coarse point c gets a unit row: P[c, cmap[c]] = 1
  * every fine point i gets its interpolation weights on the coarse
    columns of its off-diagonal edges: P[i, cmap[j]] = w_ij for coarse j

Host-side setup op (pattern-changing); P lands on the operator's device.
"""

from __future__ import annotations

import numpy as np

from gnnla_tpu_torch.ops.sparse import SparseOperator


def truncate_weights(rows, w, n, trunc: float):
    """Classical interpolation truncation: per fine row, drop entries with
    |w| < trunc * max_row |w| and rescale the survivors so the positive and
    negative row sums are preserved (Ruge-Stuben truncation). Returns
    (keep_mask, rescaled_w)."""
    w = np.asarray(w, dtype=np.float64)
    rmax = np.zeros(n)
    np.maximum.at(rmax, rows, np.abs(w))
    keep = np.abs(w) >= trunc * rmax[rows]
    pos = w > 0
    sum_pos = np.zeros(n)
    sum_neg = np.zeros(n)
    np.add.at(sum_pos, rows[pos], w[pos])
    np.add.at(sum_neg, rows[~pos], w[~pos])
    kpos = keep & pos
    kneg = keep & ~pos
    ksum_pos = np.zeros(n)
    ksum_neg = np.zeros(n)
    np.add.at(ksum_pos, rows[kpos], w[kpos])
    np.add.at(ksum_neg, rows[kneg], w[kneg])
    scale_pos = np.divide(sum_pos, ksum_pos,
                          out=np.ones_like(sum_pos), where=ksum_pos != 0)
    scale_neg = np.divide(sum_neg, ksum_neg,
                          out=np.ones_like(sum_neg), where=ksum_neg != 0)
    w2 = np.where(pos, w * scale_pos[rows], w * scale_neg[rows])
    return keep, w2


def assemble_prolongation(op_nodiag: SparseOperator, coarse_flags,
                          w_ij, *, dtype=None,
                          trunc: float = 0.0) -> SparseOperator:
    """Build P [n, n_coarse] sparsely from edge weights.

    op_nodiag    : the diagonal-removed operator whose edges carry w_ij
    coarse_flags : [N] 1/0 coarse markers (host array)
    w_ij         : [E] interpolation weights
    trunc        : interpolation truncation threshold (0 = keep all); see
                   `truncate_weights`
    """
    dtype = dtype or op_nodiag.vals.dtype
    coarse = np.asarray(coarse_flags).ravel().astype(bool)
    rows, cols, _ = op_nodiag.host_coo()
    w = np.asarray(w_ij, dtype=np.float64)
    n = op_nodiag.n_rows

    cmap = np.cumsum(coarse) - 1          # global->coarse, valid where coarse
    n_coarse = int(coarse.sum())

    keep = coarse[cols] & ~coarse[rows]   # fine rows, coarse columns
    p_rows = rows[keep]
    p_cols = cmap[cols[keep]]
    p_vals = w[keep]
    if trunc > 0.0 and p_rows.size:
        tkeep, p_vals = truncate_weights(p_rows, p_vals, n, trunc)
        p_rows, p_cols, p_vals = p_rows[tkeep], p_cols[tkeep], p_vals[tkeep]

    c_idx = np.flatnonzero(coarse)        # coarse rows: identity
    p_rows = np.concatenate([p_rows, c_idx])
    p_cols = np.concatenate([p_cols, cmap[c_idx]])
    p_vals = np.concatenate([p_vals, np.ones(n_coarse)])

    return SparseOperator.from_coo(p_rows, p_cols, p_vals, (n, n_coarse),
                                   dtype=dtype, device=op_nodiag.device)
