"""Distributed two-grid and multilevel cycles — the counterpart of
gnnla_tpu/parallel/vcycle.py.

  * A is row-block partitioned (parallel/partition.py); smoothing and the
    residual run rank-locally with ring halo exchanges,
  * P is row-partitioned with the same row blocks; restriction
    rc = P^T r is a per-rank scatter over *coarse* indices followed by a
    `psum` (each rank owns a row slice of P), after which rc is
    replicated on every rank,
  * the coarse solve runs replicated (the coarse space is small;
    redundant compute beats communicating it),
  * prolongation x += P xc is rank-local (xc is replicated).

Numerics match the single-device cycles up to f32 reassociation. Every
cycle function takes and returns this rank's local block; the setup's
operators live on this rank's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gnnla_tpu_torch.models.chebyshev import chebyshev
from gnnla_tpu_torch.ops.segment import segment_sum
from gnnla_tpu_torch.ops.sparse import SparseOperator
from gnnla_tpu_torch.parallel.collectives import (all_gather_tiled,
                                                  axis_group, axis_index,
                                                  axis_size, psum)
from gnnla_tpu_torch.parallel.distributed import mesh_device, to_global
from gnnla_tpu_torch.parallel.partition import (_by_shard, _np_dtype,
                                                partition_rows, shard_vector)
from gnnla_tpu_torch.parallel.spmv import ShardSpMV


@dataclasses.dataclass(frozen=True)
class PartitionedRect:
    """Row-block sharded rectangular operator (prolongation P [n, nc]),
    host numpy arrays with the shard as the leading axis."""

    rows_local: np.ndarray   # [S, E] int32
    cols_global: np.ndarray  # [S, E] int32 (coarse index, replicated)
    vals: np.ndarray         # [S, E]
    mask: np.ndarray         # [S, E] bool
    n_cols: int
    rows_per_shard: int


def partition_rows_rect(op, n_shards: int,
                        rows_per_shard: int) -> PartitionedRect:
    """Partition a rectangular operator by the same row blocks as its
    square companion (host-side setup)."""
    rows, cols, vals = op.host_coo()
    r_l, c_g, v, m = _by_shard(rows, cols, vals, n_shards, rows_per_shard)
    return PartitionedRect(
        rows_local=r_l.astype(np.int32), cols_global=c_g.astype(np.int32),
        vals=v.astype(_np_dtype(op.vals.dtype)), mask=m,
        n_cols=op.shape[1], rows_per_shard=rows_per_shard)


class _LocalRect:
    """This rank's rows of a PartitionedRect: P^T r summed over the ranks
    (`restrict`) and x += P xc for a replicated xc (`prolong`)."""

    def __init__(self, pp, group):
        self.rows = pp.rows_local.long()
        self.cols = pp.cols_global.long()
        self.vals, self.mask = pp.vals, pp.mask
        self.nc, self.rps = pp.n_cols, pp.rows_per_shard
        self.group = group

    def restrict(self, r: torch.Tensor) -> torch.Tensor:
        g = r[self.rows]
        part = segment_sum(torch.where(self.mask, self.vals * g,
                                       torch.zeros_like(g)),
                           self.cols, self.nc)
        return psum(part, self.group)

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        g = xc[self.cols]
        return segment_sum(torch.where(self.mask, self.vals * g,
                                       torch.zeros_like(g)),
                           self.rows, self.rps)


def make_sharded_vcycle(setup, mesh, axis: str = "rows", *, n_pre: int = 3,
                        n_post: int = 3, omega: float = 0.7,
                        coarse_deg: int = 4, coarse_c: float = -3.4,
                        coarse_d: float = -4.0):
    """Returns (cycle, part): cycle(b_local, x_local) runs one distributed
    two-grid V-cycle on this rank's [R] blocks (build them with
    `local_block(shard_vector(v, part), mesh)`).

    `setup` must carry COO operators (`setup_twogrid`, not the DIA swap:
    partitioning reads the COO pattern)."""
    if not isinstance(setup.A, SparseOperator):
        raise ValueError("make_sharded_vcycle needs a COO TwoGridSetup "
                         "(use setup_twogrid without setup_with_dia)")
    group = axis_group(mesh, axis)
    n_shards = axis_size(group)
    part = partition_rows(setup.A, n_shards)
    part_p = partition_rows_rect(setup.P, n_shards, part.rows_per_shard)
    spmv = ShardSpMV.on_mesh(part, mesh, axis)
    pp = _LocalRect(to_global(part_p, mesh, axis), group)
    d = to_global(shard_vector(setup.diag.detach().cpu().numpy(), part),
                  mesh, axis)
    d_safe = torch.where(d == 0, torch.ones_like(d), d)
    Ac = setup.Ac

    def smooth(b, x, n_iters):
        for _ in range(n_iters):
            x = x + omega * (b - spmv(x)) / d_safe
        return x

    def cycle(b, x):
        x = smooth(b, x, n_pre)
        rc = pp.restrict(b - spmv(x))
        xc = chebyshev(Ac, rc, torch.zeros_like(rc), c=coarse_c, d=coarse_d,
                       deg=coarse_deg)
        x = x + pp.prolong(xc)
        return smooth(b, x, n_post)

    return cycle, part


def make_sharded_multigrid_cycle(setup, mesh, axis: str = "rows", *,
                                 n_pre: int = 3, n_post: int = 3,
                                 omega: float = 0.7, coarse_deg: int = 8,
                                 gamma: int = 1,
                                 min_sharded_rows: int = 32768,
                                 n_sharded_levels=None, globalize=None):
    """Distributed multilevel V/W-cycle: the finest K levels run
    row-sharded (halo smoothing, `psum` restriction), the coarse tail runs
    the replicated `multigrid_cycle`.

    `globalize(sharded_tree, replicated_tree) -> (sharded, replicated)`
    places the operator trees on this rank: the sharded tree's [S, ...]
    host arrays become this rank's blocks (the default:
    `to_global(s, mesh, axis)`, and the tail as it is); a caller with
    another data path passes its own.

    With ~4x coarsening the finest levels carry nearly all the work, so
    levels down to `min_sharded_rows` rows are sharded and the small tail
    is computed on every rank. The hand-off between two sharded levels
    slices this rank's block of the `psum`ed coarse residual, recurses,
    and all-gathers the correction for the rank-local prolongation.

    Returns (cycle, part0): cycle(b_local, x_local) advances one cycle on
    this rank's [R] blocks of `part0`. Numerics match the single-device
    `multigrid_cycle` on the same setup (f32 reassociation only)."""
    from gnnla_tpu_torch.models.multigrid import (MultigridSetup,
                                                  multigrid_cycle)

    L = setup.n_levels
    for A in setup.As:
        if not isinstance(A, SparseOperator):
            raise ValueError(
                "make_sharded_multigrid_cycle needs COO operators on every "
                "level (build with setup_multigrid/setup_sa_multigrid, "
                "without the DIA swap)")
    group = axis_group(mesh, axis)
    ndev = axis_size(group)

    if n_sharded_levels is None:
        K = 0
        for A in setup.As[: L - 1]:
            if A.n_rows >= min_sharded_rows:
                K += 1
            else:
                break
        K = max(K, 1)
    else:
        K = int(n_sharded_levels)
    K = max(1, min(K, L - 1))

    parts = tuple(partition_rows(setup.As[i], ndev) for i in range(K))
    part_ps = tuple(
        partition_rows_rect(setup.Ps[i], ndev, parts[i].rows_per_shard)
        for i in range(K))
    d_blocks = tuple(shard_vector(setup.diags[i].detach().cpu().numpy(),
                                  parts[i]) for i in range(K))
    tail = MultigridSetup(As=setup.As[K:], Ps=setup.Ps[K:],
                          diags=setup.diags[K:], coarse_c=setup.coarse_c,
                          coarse_d=setup.coarse_d)
    if globalize is None:
        def globalize(s, r):
            return to_global(s, mesh, axis), r
    (parts_l, pps_l, dbs_l), tail = globalize((parts, part_ps, d_blocks),
                                              tail)

    spmvs = [ShardSpMV(p, group) for p in parts_l]
    pps = [_LocalRect(p, group) for p in pps_l]
    d_safe = [torch.where(d == 0, torch.ones_like(d), d) for d in dbs_l]
    rps = [p.rows_per_shard for p in parts]
    ncs = [setup.As[i + 1].n_rows for i in range(K)]
    idx = axis_index(group)

    def cycle(i, b, x):
        spmv, pp, ds = spmvs[i], pps[i], d_safe[i]

        def smooth(x, n_iters):
            for _ in range(n_iters):
                x = x + omega * (b - spmv(x)) / ds
            return x

        x = smooth(x, n_pre)
        nc = ncs[i]
        for _ in range(gamma):
            rc = pp.restrict(b - spmv(x))
            if i + 1 < K:
                rps_c = rps[i + 1]
                rc_pad = torch.nn.functional.pad(rc, (0, rps_c * ndev - nc))
                rc_loc = rc_pad[idx * rps_c: (idx + 1) * rps_c]
                xc_loc = cycle(i + 1, rc_loc, torch.zeros_like(rc_loc))
                xc = all_gather_tiled(xc_loc, group)[:nc]
            else:
                xc = multigrid_cycle(tail, rc, torch.zeros_like(rc),
                                     n_pre=n_pre, n_post=n_post,
                                     omega=omega, coarse_deg=coarse_deg,
                                     gamma=gamma)
            x = x + pp.prolong(xc)
        return smooth(x, n_post)

    def cycle_fn(b_local, x_local):
        return cycle(0, b_local, x_local)

    return cycle_fn, parts[0]


def make_sharded_stream_vcycle(setup, mesh, axis: str = "rows", *,
                               n_pre: int = 3, n_post: int = 3,
                               omega: float = 0.7, coarse_deg: int = 4,
                               coarse_c: float = -3.4,
                               coarse_d: float = -4.0,
                               min_halo_tiles: int = 0):
    """Distributed two-grid V-cycle with the fine level on K2 per shard
    (parallel/stream.py) instead of the COO gather path.

    The whole fine-level problem is permuted into the kernel's RCM order
    at setup: A becomes per-rank K2 shards with ring halos, P's rows are
    permuted to match, and the smoother diagonal rides in the padded
    layout (ones on the padded rows, whose b is 0, so x stays 0 there).
    Smoothing and the residual run on K2; restriction, the coarse solve
    and prolongation keep `make_sharded_vcycle`'s psum/replicated
    structure. Numerics match the single-device `vcycle` on the same
    setup (f32 reassociation only).

    Returns (cycle, kern): cycle(b_l, x_l) advances one cycle on this
    rank's [R] blocks of the padded kernel-order vectors (build them with
    kern.shard(kern.to_padded(v)); map results back with
    kern.from_padded(kern.gather(x_l)))."""
    from gnnla_tpu_torch.parallel.stream import build_sharded_stream

    if not isinstance(setup.A, SparseOperator):
        raise ValueError("make_sharded_stream_vcycle needs a COO "
                         "TwoGridSetup (build with setup_twogrid)")
    import scipy.sparse as sp

    kern = build_sharded_stream(setup.A, mesh, axis,
                                min_halo_tiles=min_halo_tiles)
    group = axis_group(mesh, axis)
    ndev = axis_size(group)
    n, N = kern.n, kern.padded_len
    R = N // ndev
    nc = setup.P.shape[1]
    dev = mesh_device(mesh)
    Ac = setup.Ac

    # P with its rows in kernel (RCM) order, the padded rows empty
    Pk = setup.P.to_scipy().tocsr()
    if kern.perm is not None:
        Pk = Pk[kern.perm]
    Pk = sp.vstack([Pk, sp.csr_matrix((N - n, nc), dtype=Pk.dtype)],
                   format="csr")
    part_p = partition_rows_rect(
        SparseOperator.from_scipy(Pk, dtype=setup.P.vals.dtype,
                                  device="cpu"), ndev, R)
    pp = _LocalRect(to_global(part_p, mesh, axis), group)

    d_host = setup.diag.detach().cpu().numpy().astype(np.float64)
    if kern.perm is not None:
        d_host = d_host[kern.perm]
    d_pad = np.concatenate([d_host, np.ones(N - n)])
    d_pad[d_pad == 0] = 1.0
    d_l = kern.shard(torch.from_numpy(d_pad.astype(np.float32)).to(dev))
    w_over_d = omega / d_l

    def smooth(b, x, n_iters):
        for _ in range(n_iters):
            x = x + w_over_d * (b - kern.local_apply(x))
        return x

    def cycle(b, x):
        x = smooth(b, x, n_pre)
        rc = pp.restrict(b - kern.local_apply(x))
        xc = chebyshev(Ac, rc, torch.zeros_like(rc), c=coarse_c, d=coarse_d,
                       deg=coarse_deg)
        x = x + pp.prolong(xc)
        return smooth(b, x, n_post)

    return cycle, kern
