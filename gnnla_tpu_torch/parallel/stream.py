"""Row-block-sharded SpMV on general graphs: kernel K2 per shard — the
counterpart of gnnla_tpu/parallel/stream.py.

After reverse Cuthill-McKee ordering the rows of a block reference a
*bounded* column window, so each rank needs only

  its own x block  +  h tiles of 1024 entries from each ring neighbour,

exchanged with two ring shifts — the stencil path's halo pattern with the
reach measured from the matrix. Each rank's operator is then one CSR of R
rows by R + 2·h·1024 columns (its rows of the padded, RCM-ordered A, the
columns shifted by base = d·R − h·1024), and one apply is the two shifts,
a concatenation and one K2 launch (`ops/stream_spmv.CsrSpMV`,
csrc/csr_spmv.cu) on the card; on the CPU the same wrapper runs its plain
version. The padded length, the shard bounds and the halo reach are
counted in the JAX package's 1024-row tiles, so they equal its own; the
TPU pack (superchunk words, window widths, step padding) and its
[t, 8, 128] vector layout have no counterpart: vectors are flat [R].

Differentiable (`with_grad=True`): `apply_diff(vals, x_local)` carries
the JAX custom VJP — the x cotangent is K2 on each shard's transposed
CSR followed by the reversed halo exchange (the halo slabs of the
gradient are added back on their owner ranks: `ring_shift`'s backward),
and the values' cotangent is ybar[row] * x_ext[col] per CSR entry of the
shard.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gnnla_tpu_torch.ops.stream_spmv import (TILE, CsrSpMV, _CsrGrad,
                                             check_stream_pattern,
                                             link_transposes, rcm_csr)
from gnnla_tpu_torch.parallel.collectives import (axis_group, axis_index,
                                                  axis_size, ring_shift)
from gnnla_tpu_torch.parallel.distributed import gather_vector, mesh_device
from gnnla_tpu_torch.parallel.stencil import HBM_BW, NVLINK_BW


def _pad_square(A_csr, n_pad: int):
    """A padded to n_pad x n_pad with a unit diagonal on the new rows (so
    every shard holds entries; the padded region of x is zero, so the
    extra rows never change real outputs)."""
    from scipy import sparse as sp

    n = A_csr.shape[0]
    if n_pad == n:
        return A_csr
    eye = sp.identity(n_pad - n, dtype=np.float32, format="csr")
    return sp.bmat([[A_csr, None], [None, eye]], format="csr")


def _shard_halo_tiles(A_csr, ndev: int, rows_per_shard: int) -> int:
    """Max over shards of the column overreach beyond the shard's own row
    range, in whole 1024-entry tiles."""
    h = 0
    for d in range(ndev):
        sub = A_csr[d * rows_per_shard: (d + 1) * rows_per_shard]
        if sub.nnz == 0:
            continue
        lo = d * rows_per_shard - int(sub.indices.min())
        hi = int(sub.indices.max()) + 1 - (d + 1) * rows_per_shard
        h = max(h, -(-lo // TILE) if lo > 0 else 0,
                -(-hi // TILE) if hi > 0 else 0)
    return h


def _shard_csr(A, d: int, R: int, h: int):
    """Shard d's rows of the padded A as an R x (R + 2hT) CSR with its
    columns relative to base = d R - h T (float32 values)."""
    from scipy import sparse as sp

    sub = A[d * R: (d + 1) * R].tocsr()
    base = d * R - h * TILE
    ncol_ext = R + 2 * h * TILE
    if sub.nnz == 0:  # the padded diagonal prevents this in practice
        return sp.csr_matrix(
            (np.zeros(1, np.float32), np.array([d * R - base], np.int64),
             np.concatenate([[0], np.ones(R, np.int64)])),
            shape=(R, ncol_ext))
    return sp.csr_matrix((sub.data.astype(np.float32), sub.indices - base,
                          sub.indptr), shape=(R, ncol_ext))


@dataclasses.dataclass
class ShardedStreamSpMV:
    """K2 per shard over a 1-D mesh axis; this rank's part of it.

    apply(x_local)          : y_local = (A x)_local on this rank's [R]
                              block of the padded, kernel-order vector
                              (chainable — solvers iterate on it); one K2
                              launch (`fwd.launches`) and two ring shifts
    local_apply             : the same function, named as the JAX body a
                              larger composition embeds
    apply_diff(vals, x)     : apply with the VJP in x and in this shard's
                              CSR values (with_grad=True); `diff_args` is
                              the shard's values tensor
    to_padded / shard / gather / from_padded : caller-order [n] ->
                              padded kernel-order [N] -> this rank's [R]
                              and back; matvec(x) does all of it
    """

    mesh: object
    axis: str
    n: int
    nnz: int
    t_global: int
    h_tiles: int
    perm: Optional[np.ndarray]
    fwd: CsrSpMV                # this rank's shard on K2
    shard_nnz: Tuple[int, ...]  # the CSR nonzeros of every shard
    device: torch.device
    diff_args: Optional[torch.Tensor] = None

    @property
    def padded_len(self) -> int:
        return self.t_global * TILE

    @property
    def rows_per_shard(self) -> int:
        return self.padded_len // axis_size(self.group)

    @property
    def group(self):
        return axis_group(self.mesh, self.axis)

    def extend(self, x_l: torch.Tensor) -> torch.Tensor:
        """[x_{d-1}[-hT:] | x_d | x_{d+1}[:hT]] by two ring shifts."""
        if self.h_tiles == 0:
            return x_l
        ht = self.h_tiles * TILE
        top = ring_shift(x_l[-ht:], 1, self.group)
        bot = ring_shift(x_l[:ht], -1, self.group)
        return torch.cat([top, x_l, bot])

    def apply(self, x_l: torch.Tensor) -> torch.Tensor:
        return self.fwd(self.extend(x_l))

    local_apply = apply

    def apply_diff(self, vals: torch.Tensor,
                   x_l: torch.Tensor) -> torch.Tensor:
        if self.fwd.transpose is None:
            raise ValueError("build_sharded_stream(..., with_grad=True) "
                             "builds the transposed shards apply_diff needs")
        return _CsrGrad.apply(self.extend(x_l), vals, self.fwd)

    def to_padded(self, x) -> torch.Tensor:
        """Caller-order [n] -> kernel-order [N], zero-padded, float32 on
        this rank's device."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32))
        x = x.to(self.device, torch.float32)
        if self.perm is not None:
            x = x[torch.from_numpy(self.perm).to(self.device)]
        return torch.nn.functional.pad(x, (0, self.padded_len - self.n))

    def shard(self, xp: torch.Tensor) -> torch.Tensor:
        """This rank's [R] block of a padded [N] vector."""
        R = self.rows_per_shard
        d = axis_index(self.group)
        return xp[d * R: (d + 1) * R].contiguous()

    def gather(self, y_l: torch.Tensor) -> torch.Tensor:
        """The ranks' [R] blocks -> the padded [N] vector on every rank."""
        return gather_vector(y_l, self.mesh, self.axis).reshape(-1)

    def from_padded(self, y) -> np.ndarray:
        """Padded kernel-order [N] -> caller-order [n] host vector."""
        yk = (y.detach().cpu().numpy() if isinstance(y, torch.Tensor)
              else np.asarray(y)).reshape(-1)[: self.n]
        if self.perm is not None:
            return yk[np.argsort(self.perm)]
        return yk

    def matvec(self, x) -> np.ndarray:
        """A x on caller-order [n] host vectors (every rank passes the
        same x and gets the whole y)."""
        return self.from_padded(self.gather(self.apply(
            self.shard(self.to_padded(x)))))


def build_sharded_stream(op, mesh, axis: str = "rows", *,
                         reorder: bool = True, with_grad: bool = False,
                         min_halo_tiles: int = 0) -> ShardedStreamSpMV:
    """Build this rank's K2 shard from a SparseOperator or a scipy matrix
    (host setup; every rank runs the same build and keeps its own shard).

    Row blocks are contiguous ranges of the (RCM-ordered) operator, one per
    rank of `axis`; the halo reach is measured from the matrix and must
    not exceed one shard (ValueError otherwise, on every rank alike, as
    are the patterns the JAX packer refuses). `min_halo_tiles > 0` keeps
    the halo exchange in the program even where the matrix needs none,
    as on a 1-rank mesh (the JAX hardware check's device)."""
    A = op.to_scipy().tocsr() if hasattr(op, "to_scipy") else op.tocsr()
    A.sort_indices()
    perm = None
    if reorder:
        A, perm = rcm_csr(A)
        perm = np.ascontiguousarray(perm)
    n = A.shape[0]
    group = axis_group(mesh, axis)
    ndev = axis_size(group)

    t_global = -(-n // TILE)
    t_global = -(-t_global // ndev) * ndev
    N = t_global * TILE
    A = _pad_square(A, N)
    A.sort_indices()
    R = N // ndev
    t_loc = R // TILE

    h = max(_shard_halo_tiles(A, ndev, R), min_halo_tiles)
    if h > t_loc:  # h == t_loc is the whole neighbour block — still a ring
        raise ValueError(
            f"halo reach {h} tiles >= {t_loc}-tile shard: RCM bandwidth too "
            f"wide for {ndev} shards at n={n}; use fewer devices or the "
            "COO sharded path (parallel/spmv.py)")
    ncol_ext = R + 2 * h * TILE

    # every rank checks every shard, so a refusal raises on all of them
    shards = [_shard_csr(A, d, R, h) for d in range(ndev)]
    for sub in shards:
        check_stream_pattern(sub.indptr, sub.indices, ncol_ext)
    transposes = None
    if with_grad:
        transposes = []
        for sub in shards:
            At = sub.T.tocsr()
            At.sort_indices()
            check_stream_pattern(At.indptr, At.indices, R)
            transposes.append(At)

    device = mesh_device(mesh)
    d = axis_index(group)
    fwd = CsrSpMV(shards[d], device=device)
    if with_grad:
        link_transposes(fwd, CsrSpMV(transposes[d], device=device))
    return ShardedStreamSpMV(
        mesh=mesh, axis=axis, n=n, nnz=int(A.nnz) - (N - n),
        t_global=t_global, h_tiles=h, perm=perm, fwd=fwd,
        shard_nnz=tuple(int(s.nnz) for s in shards), device=device,
        diff_args=fwd.vals if with_grad else None)


def stream_scaling_model(kern: ShardedStreamSpMV, *,
                         scale_rows: float = 1.0, hbm_bw: float = HBM_BW,
                         link_bw: float = NVLINK_BW) -> dict:
    """Comm-vs-local-work accounting for one sharded K2 SpMV.

    Local HBM traffic per device: the largest shard's CSR (values and
    column indices, 8 bytes a nonzero, and its row pointers), its
    halo-extended x and its y, each moved once. Comm: 2h tiles of halo
    per device over one link (top and bottom at once).

    scale_rows > 1 projects the same operator family at a larger n: the
    halo is set by the RCM bandwidth (scale-free), local work grows with
    rows per device — so the efficiency is a floor at scale."""
    ndev = axis_size(kern.group)
    R = kern.rows_per_shard
    ht = kern.h_tiles * TILE
    local_bytes = (max(kern.shard_nnz) * 8 + (R + 1) * 4
                   + (R + 2 * ht) * 4 + R * 4) * scale_rows
    t_local = local_bytes / hbm_bw
    comm_bytes = 2 * ht * 4 if ndev > 1 else 0
    t_comm = comm_bytes / link_bw
    eff_serial = t_local / (t_local + t_comm) if t_local else 1.0
    eff_overlap = min(1.0, t_local / max(t_local, t_comm)) \
        if t_local else 1.0
    return {
        "ndev": ndev,
        "local_bytes_per_chip": local_bytes,
        "comm_bytes_per_chip": comm_bytes,
        "efficiency_serial": eff_serial,
        "efficiency_overlapped": eff_overlap,
        "edges_per_s_aggregate":
            kern.nnz * scale_rows / max(t_local + t_comm, 1e-30),
    }
