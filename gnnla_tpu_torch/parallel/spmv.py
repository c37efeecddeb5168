"""Sharded SpMV and iterative kernels on `torch.distributed` — the
counterpart of gnnla_tpu/parallel/spmv.py.

Each rank owns a row block of the operator and the matching slice of
x/b. One SpMV =

  1. halo exchange — ring shifts of the boundary slices of x to the
     ring neighbours (banded operators reach only ring neighbours;
     general operators fall back to an all-gather of x),
  2. local gather -> multiply -> scatter-add over the block's rows,

with global reductions (norms, Rayleigh quotients) as `psum`s. Locally
this is the COO path (index_select + index_add_), as in the JAX package,
which runs no Pallas kernel here either.

The `make_sharded_*` functions take a `PartitionedOperator` and a mesh,
keep this rank's row of it on the rank's device, and return functions of
this rank's local [R] blocks.
"""

from __future__ import annotations

import torch

from gnnla_tpu_torch.ops.segment import segment_sum
from gnnla_tpu_torch.parallel.collectives import (all_gather_tiled,
                                                  axis_group, axis_index,
                                                  axis_size, psum,
                                                  ring_shift)
from gnnla_tpu_torch.parallel.distributed import to_global
from gnnla_tpu_torch.parallel.partition import PartitionedOperator


def _halo_exchange(x_local: torch.Tensor, halo: int, group) -> torch.Tensor:
    """x_ext = [left_halo | x_local | right_halo] via two ring shifts."""
    n_dev = axis_size(group)
    if halo == 0 or n_dev == 1:
        pad = x_local.new_zeros((halo,) + tuple(x_local.shape[1:]))
        return torch.cat([pad, x_local, pad])
    idx = axis_index(group)
    # my first `halo` entries go to the left neighbour (its right halo),
    # my last `halo` entries to the right neighbour
    right_halo = ring_shift(x_local[:halo], -1, group)
    left_halo = ring_shift(x_local[-halo:], 1, group)
    # the global edge blocks have no real neighbour; no real column
    # reaches the wrapped values, but they are zeroed as in JAX. `where`
    # keeps the zeroed shift in the autograd graph, so every rank's
    # backward makes the same ring shifts (a cut shift would leave its
    # partner's backward exchange unmatched)
    if idx == 0:
        left_halo = torch.where(torch.zeros((), dtype=torch.bool,
                                            device=left_halo.device),
                                left_halo, torch.zeros_like(left_halo))
    if idx == n_dev - 1:
        right_halo = torch.where(torch.zeros((), dtype=torch.bool,
                                             device=right_halo.device),
                                 right_halo, torch.zeros_like(right_halo))
    return torch.cat([left_halo, x_local, right_halo])


class ShardSpMV:
    """y_local = (A x)_local on this rank's row block: `part_local` is a
    `PartitionedOperator` whose arrays are this rank's rows (`to_global`);
    ring halos when halo_reach <= 1, else an all-gather of x."""

    def __init__(self, part_local: PartitionedOperator, group):
        self.group = group
        self.rows_l = part_local.rows_local.long()
        self.cols_e = part_local.cols_ext.long()
        self.cols_g = part_local.cols_global.long()
        self.vals, self.mask = part_local.vals, part_local.mask
        self.rps, self.halo = part_local.rows_per_shard, part_local.halo
        self.use_halo = part_local.halo_reach <= 1

    @classmethod
    def on_mesh(cls, part: PartitionedOperator, mesh,
                axis: str = "rows") -> "ShardSpMV":
        """This rank's ShardSpMV of a host partition."""
        return cls(to_global(part, mesh, axis), axis_group(mesh, axis))

    def __call__(self, x_local: torch.Tensor) -> torch.Tensor:
        if self.use_halo:
            x_ext = _halo_exchange(x_local, self.halo, self.group)
            gathered = x_ext[self.cols_e]
        else:
            gathered = all_gather_tiled(x_local, self.group)[self.cols_g]
        prod = torch.where(self.mask, self.vals * gathered,
                           torch.zeros_like(gathered))
        return segment_sum(prod, self.rows_l, self.rps)


def make_sharded_matvec(part: PartitionedOperator, mesh, axis: str = "rows"):
    """Returns y_local = (A x)_local of this rank's [R] block."""
    return ShardSpMV.on_mesh(part, mesh, axis)


def _safe(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d == 0, torch.ones_like(d), d)  # padding rows


def make_sharded_jacobi(part: PartitionedOperator, mesh, axis: str = "rows"):
    """Returns run(b, x, d, omega, n_iters) -> x after n_iters weighted
    Jacobi sweeps on this rank's [R] blocks, one halo exchange per
    sweep."""
    spmv = ShardSpMV.on_mesh(part, mesh, axis)

    def run(b, x, d, omega, n_iters):
        d_safe = _safe(d)
        for _ in range(int(n_iters)):
            x = x + omega * (b - spmv(x)) / d_safe
        return x

    return run


def make_sharded_power_method(part: PartitionedOperator, mesh,
                              axis: str = "rows"):
    """Returns run(b0_local, n_iters) -> (lambda_max, b_local): the
    normalised iteration with one halo exchange per SpMV, and the norms
    and the Rayleigh quotient as `psum` reductions over the whole graph
    (the collectives the reference's torch.sum global aggregations map
    to, PowerMethodGNN.py:50-61)."""
    spmv = ShardSpMV.on_mesh(part, mesh, axis)
    g = spmv.group

    def run(b, n_iters):
        for _ in range(int(n_iters)):
            ab = spmv(b)
            b = ab / torch.sqrt(psum(torch.sum(ab * ab), g))
        ab = spmv(b)
        lam = psum(torch.sum(b * ab), g) / psum(torch.sum(b * b), g)
        return lam, b

    return run


def make_sharded_norm(part: PartitionedOperator, mesh, axis: str = "rows"):
    """Returns ||x||_2 of a sharded vector (a `psum` of local squares)."""
    g = axis_group(mesh, axis)

    def norm(x_local):
        return torch.sqrt(psum(torch.sum(x_local * x_local), g))

    return norm
