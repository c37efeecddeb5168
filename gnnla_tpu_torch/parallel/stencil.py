"""Row-block-sharded grid-stencil kernels and their scaling model — the
counterpart of gnnla_tpu/parallel/stencil.py.

The grid's rows (H axis) are block-sharded over a mesh axis; each rank
holds its [H/ndev, W] slab of the tap planes and of the vector, and one
matvec is

  1. halo exchange — ring shifts of the top/bottom `r` rows (r = the
     stencil's signed row reach, 1 for 9-point FEM stencils),
  2. local tap accumulation — K static row slices and column rolls of the
     halo-extended slab, in plain PyTorch: the JAX package computes this
     in plain XLA and does not call its stencil kernel (K4) here.

The ring wraps at the global boundary, which gives the modular tap
semantics y[r,c] = sum_k p_k[r,c] * x[(r+dy)%H, (c+dx)%W] exactly:
periodic operators get their wrap from the ring, Dirichlet operators have
zero taps at the boundary, so the wrapped values multiply zero.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from gnnla_tpu_torch.parallel.collectives import (axis_group, axis_index,
                                                  axis_size, ring_shift)
from gnnla_tpu_torch.parallel.distributed import _tensor, mesh_device

# Spec-sheet constants of the card for the analytic models (bytes/s), not
# measurements: NVIDIA H100 80GB HBM3 (SXM, 700 W) HBM3 bandwidth, and
# NVLink 4's bandwidth per direction between two cards (900 GB/s both
# ways).
HBM_BW = 3.35e12
NVLINK_BW = 4.5e11


def signed_row_shifts(shifts: List[Tuple[int, int]], h: int) -> List[int]:
    """Map modular dy in [0, H) to the signed shift in (-H/2, H/2]."""
    return [dy if dy <= h // 2 else dy - h for dy, _ in shifts]


def _halo_rows(x_l: torch.Tensor, r: int, group) -> torch.Tensor:
    """[hl, W, ...] -> [hl + 2r, W, ...] with ring-wrapped row halos."""
    if r == 0:
        return x_l
    if axis_size(group) == 1:
        return torch.cat([x_l[-r:], x_l, x_l[:r]], dim=0)
    # my top r rows are the bottom halo of the previous rank, my bottom r
    # rows the top halo of the next: the ring wrap is the modular row
    top_halo = ring_shift(x_l[-r:], 1, group)
    bottom_halo = ring_shift(x_l[:r], -1, group)
    return torch.cat([top_halo, x_l, bottom_halo], dim=0)


def _local_stencil(planes_l: torch.Tensor, x_ext: torch.Tensor, r: int,
                   shifts: List[Tuple[int, int]],
                   sy: List[int]) -> torch.Tensor:
    """Tap accumulation on a halo-extended slab. planes_l [K, hl, W],
    x_ext [hl + 2r, W] or [hl + 2r, W, m]."""
    hl = planes_l.shape[1]
    acc = None
    for k, (_, dx) in enumerate(shifts):
        xs = x_ext[r + sy[k]: r + sy[k] + hl]
        xs = torch.roll(xs, -dx, dims=1)
        p = planes_l[k] if x_ext.ndim == 2 else planes_l[k][:, :, None]
        term = p * xs
        acc = term if acc is None else acc + term
    return acc


def _check_grid(h: int, ndev: int, r: int) -> int:
    if h % ndev:
        raise ValueError(f"grid H={h} not divisible by {ndev} shards")
    hl = h // ndev
    if r > hl:
        raise ValueError(f"stencil row reach {r} exceeds the {hl}-row "
                         f"shard; use fewer devices")
    return hl


def _geometry(shifts, grid_shape, mesh, axis):
    h, _ = grid_shape
    group = axis_group(mesh, axis)
    sy = signed_row_shifts(shifts, h)
    r = max((abs(s) for s in sy), default=0)
    _check_grid(h, axis_size(group), r)
    return group, sy, r


def make_sharded_stencil_matvec(shifts: List[Tuple[int, int]],
                                grid_shape: Tuple[int, int], mesh,
                                axis: str = "rows"):
    """Returns run(planes_l [K, hl, W], x_l [hl, W]) -> y_l [hl, W], on
    this rank's row slabs; x_l may be an [hl, W, m] probe block."""
    group, sy, r = _geometry(shifts, grid_shape, mesh, axis)

    def run(planes_l, x_l):
        return _local_stencil(planes_l, _halo_rows(x_l, r, group), r,
                              shifts, sy)

    return run


def make_sharded_stencil_jacobi(shifts: List[Tuple[int, int]],
                                grid_shape: Tuple[int, int], mesh,
                                axis: str = "rows"):
    """Returns run(planes_l, diag_l, b_l, x_l, omega, n_iters) -> x_l
    after n_iters weighted-Jacobi sweeps on this rank's slabs, one halo
    exchange per sweep."""
    group, sy, r = _geometry(shifts, grid_shape, mesh, axis)

    def run(planes_l, d_l, b_l, x_l, omega, n_iters):
        d_safe = torch.where(d_l == 0, torch.ones_like(d_l), d_l)
        for _ in range(int(n_iters)):
            ax = _local_stencil(planes_l, _halo_rows(x_l, r, group), r,
                                shifts, sy)
            x_l = x_l + omega * (b_l - ax) / d_safe
        return x_l

    return run


def _rows_of(a, dim: int, mesh, axis: str) -> torch.Tensor:
    group = axis_group(mesh, axis)
    n, i = axis_size(group), axis_index(group)
    h = a.shape[dim]
    if h % n:
        raise ValueError(f"grid H={h} not divisible by {n} shards")
    hl = h // n
    idx = [slice(None)] * a.ndim
    idx[dim] = slice(i * hl, (i + 1) * hl)
    return _tensor(a[tuple(idx)], mesh_device(mesh)).contiguous()


def shard_planes(planes, mesh, axis: str = "rows") -> torch.Tensor:
    """This rank's row slab [K, hl, W] of tap planes [K, H, W]."""
    return _rows_of(planes, 1, mesh, axis)


def shard_vec2d(x, mesh, axis: str = "rows") -> torch.Tensor:
    """This rank's row slab of a grid vector [H, W] (or of a probe block
    [H, W, m])."""
    return _rows_of(x, 0, mesh, axis)


def stencil_scaling_model(h: int, w: int, k_taps: int, ndev: int, *,
                          halo: int = 1, dtype_bytes: int = 4,
                          hbm_bw: float = HBM_BW,
                          link_bw: float = NVLINK_BW) -> dict:
    """Analytic comm-vs-local-work accounting for one sharded stencil SpMV
    (the JAX package's model, with the card's spec-sheet rates).

    Local time = per-device HBM traffic / bandwidth (the SpMV is
    memory-bound: K tap planes and the in/out vectors stream once).
    Comm time = halo bytes over one link (top and bottom rows, sent and
    received at once on different links). `overlapped` assumes the
    interior taps hide the halo exchange, `serial` assumes no overlap;
    the truth lies between."""
    n = h * w
    local_bytes = (k_taps * n + 2 * n) * dtype_bytes / ndev
    t_local = local_bytes / hbm_bw
    comm_bytes = 2 * halo * w * dtype_bytes if ndev > 1 else 0
    t_comm = comm_bytes / link_bw
    nnz = k_taps * n  # one tap entry per (class, row) pair, an upper bound
    eff_serial = t_local / (t_local + t_comm) if t_local else 1.0
    eff_overlap = min(1.0, t_local / max(t_local, t_comm)) \
        if t_local else 1.0
    return {
        "ndev": ndev,
        "local_bytes_per_chip": local_bytes,
        "comm_bytes_per_chip": comm_bytes,
        "t_local_us": t_local * 1e6,
        "t_comm_us": t_comm * 1e6,
        "efficiency_serial": eff_serial,
        "efficiency_overlapped": eff_overlap,
        "edges_per_s_aggregate": nnz / max(t_local + t_comm, 1e-30) * ndev
        if ndev > 1 else nnz / max(t_local, 1e-30),
    }
