"""Row-block partitioning of sparse operators for multi-device execution —
the counterpart of gnnla_tpu/parallel/partition.py.

Edge-partition the matrix graph by *row blocks* over a mesh axis, keep x
and b sharded by row, and exchange only the boundary (halo) entries of x
between ring neighbours.

Partitioning is a host-side setup op in numpy, and its arrays are
bitwise the JAX package's. A `PartitionedOperator` holds host arrays
whose leading axis is the shard; each rank picks its own row with
`distributed.to_global` (or the `make_sharded_*` functions do it):

  * rows are padded to a multiple of n_shards,
  * each shard's edges are padded to the max per-shard nnz,
  * per-shard edges store the *local* row index and the *global* column,
  * halo metadata: for banded operators each shard's columns fall within
    [start - H, end + H) for a small H, so the exchange is one ring shift
    to each neighbour; the general fallback is an all-gather of x.
    `halo_reach` records how many neighbour shards each side needs (0 =
    fully local, 1 = ring neighbours, > 1 -> all-gather).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _np_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


@dataclasses.dataclass(frozen=True)
class PartitionedOperator:
    """Row-block sharded sparse operator (leading axis = shard), host
    numpy arrays."""

    rows_local: np.ndarray   # [S, E] int32, local row index within the block
    cols_ext: np.ndarray     # [S, E] int32, index into the halo-extended x
    cols_global: np.ndarray  # [S, E] int32, global column (all-gather path)
    vals: np.ndarray         # [S, E]
    mask: np.ndarray         # [S, E] bool, False on padding
    n_rows: int
    n_rows_padded: int
    rows_per_shard: int
    n_shards: int
    halo: int
    halo_reach: int

    @property
    def edges_per_shard(self) -> int:
        return self.rows_local.shape[1]


def _by_shard(rows, cols, vals, n_shards: int, rps: int):
    """(rows_local, cols_global, vals, mask) [S, E] arrays: each shard's
    edges in their COO order, padded to the largest shard."""
    shard_of = rows // rps
    e_max = max(int(np.max(np.bincount(shard_of, minlength=n_shards))), 1)
    r_l = np.zeros((n_shards, e_max), dtype=np.int64)
    c_g = np.zeros((n_shards, e_max), dtype=np.int64)
    v = np.zeros((n_shards, e_max), dtype=np.float64)
    m = np.zeros((n_shards, e_max), dtype=bool)
    for s in range(n_shards):
        sel = shard_of == s
        k = int(sel.sum())
        r_l[s, :k] = rows[sel] - s * rps
        c_g[s, :k] = cols[sel]
        v[s, :k] = vals[sel]
        m[s, :k] = True
    return r_l, c_g, v, m


def partition_rows(op, n_shards: int) -> PartitionedOperator:
    """Partition a square SparseOperator into row blocks (host-side)."""
    n = op.n_rows
    rows, cols, vals = op.host_coo()

    rps = -(-n // n_shards)           # rows per shard (ceil)
    n_pad = rps * n_shards
    r_l, c_g, v, m = _by_shard(rows, cols, vals, n_shards, rps)

    halo = 0
    reach = 0
    for s in range(n_shards):
        c = c_g[s][m[s]]
        if c.size:
            start = s * rps
            left = max(0, start - int(c.min()))
            right = max(0, int(c.max()) - (start + rps - 1))
            halo = max(halo, left, right)
            # how many neighbour blocks away the shard reaches
            reach = max(reach,
                        -(-left // rps) if left else 0,
                        -(-right // rps) if right else 0)

    # halo-extended local column: x_ext = [left_halo | local | right_halo];
    # a ring exchange ships at most one neighbour block
    halo = min(halo, rps)
    starts = (np.arange(n_shards) * rps)[:, None]
    # padding entries clamped into range
    c_e = np.clip(c_g - starts + halo, 0, rps + 2 * halo - 1)

    return PartitionedOperator(
        rows_local=r_l.astype(np.int32), cols_ext=c_e.astype(np.int32),
        cols_global=c_g.astype(np.int32),
        vals=v.astype(_np_dtype(op.vals.dtype)), mask=m,
        n_rows=n, n_rows_padded=n_pad, rows_per_shard=rps,
        n_shards=n_shards, halo=int(halo), halo_reach=int(reach))


def shard_vector(x, part: PartitionedOperator):
    """Pad [N] -> [S, R] row-block layout (numpy array or tensor)."""
    pad = part.n_rows_padded - part.n_rows
    if isinstance(x, torch.Tensor):
        x = torch.nn.functional.pad(x.reshape(-1), (0, pad))
    else:
        x = np.concatenate([np.ravel(x), np.zeros(pad, np.asarray(x).dtype)])
    return x.reshape(part.n_shards, part.rows_per_shard)


def unshard_vector(xs, part: PartitionedOperator):
    """[S, R] -> [N]."""
    return xs.reshape(-1)[: part.n_rows]
