"""The collectives of the sharded kernels on `torch.distributed` — what
`jax.lax.ppermute`, `psum`, `all_gather`, `axis_index` and `axis_size` do
inside the JAX package's `shard_map` bodies.

Every function takes the process group of one mesh axis
(`DeviceMesh.get_group(axis)`, see `axis_group`). Every rank makes the
same collective calls in the same order, as every rank of a `shard_map`
runs one program.

  * `ring_shift(t, offset, group)` — the ring `ppermute`: rank i sends t
    to rank (i + offset) mod n and returns what rank (i - offset) mod n
    sent. Differentiable: the backward shifts the cotangent the other
    way. A 1-rank ring gives t back (JAX's perm [(0, 0)] is the
    identity).
  * `psum(t, group)` — the sum over the ranks (all-reduce SUM), not
    differentiable (the solvers' reductions); `psum_replicated`, its
    differentiable form for a loss that every rank computes alike.
  * `pmax(t, group)` — the max over the ranks.
  * `all_gather_tiled(t, group)` — the ranks' blocks concatenated along
    dim 0 in rank order (`all_gather(..., tiled=True)`).
  * `axis_index(group)`, `axis_size(group)`.

Backends: NCCL takes CUDA tensors and gloo CPU tensors. Gloo has no
transport for CUDA memory, so a CUDA tensor on a gloo group (two ranks on
one card, where NCCL refuses the duplicate device) goes through pinned
host memory: copied out, exchanged, copied back. That staging happens
here only, and `staged_transfers` counts it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# CUDA tensors exchanged through pinned host memory (gloo only)
staged_transfers = 0


def axis_group(mesh, axis: str):
    """The process group of `axis` on a DeviceMesh."""
    return mesh.get_group(axis)


def axis_size(group) -> int:
    return dist.get_world_size(group)


def axis_index(group) -> int:
    return dist.get_rank(group)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    global staged_transfers
    staged_transfers += 1
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _exchange(t: torch.Tensor, dst: int, src: int, group) -> torch.Tensor:
    """Send t to group rank dst, receive a tensor like t from src."""
    t = t.contiguous()
    staged = _staged(t, group)
    send = _to_host(t) if staged else t
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, dst),
                      group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, src),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(t.device, non_blocking=False) if staged else recv


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, offset, group):
        ctx.offset, ctx.group = offset, group
        n, i = axis_size(group), axis_index(group)
        return _exchange(t, (i + offset) % n, (i - offset) % n, group)

    @staticmethod
    def backward(ctx, g):
        return ring_shift(g, -ctx.offset, ctx.group), None, None


def ring_shift(t: torch.Tensor, offset: int, group) -> torch.Tensor:
    """ppermute with perm [(i, (i + offset) % n)]: rank i returns the t of
    rank (i - offset) mod n. A 1-rank ring (or a shift by a multiple of
    n) returns t itself."""
    if offset % axis_size(group) == 0:
        return t
    return _RingShift.apply(t, offset, group)


def _all_reduce(t: torch.Tensor, group, op) -> torch.Tensor:
    out = t.detach().clone()
    if _staged(out, group):
        h = _to_host(out)
        dist.all_reduce(h, op=op, group=group)
        return h.to(out.device)
    dist.all_reduce(out, op=op, group=group)
    return out


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of t over the group's ranks (a new tensor)."""
    return _all_reduce(t, group, dist.ReduceOp.SUM)


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce(t, group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum_replicated(t: torch.Tensor, group) -> torch.Tensor:
    """`psum`, differentiable where every rank goes on to compute the same
    value from the sum (a loss replicated over the group, each rank
    backpropagating it): the cotangent of this rank's addend is then the
    sum's own cotangent, passed through unchanged. Summing the cotangents
    over the ranks instead would scale every gradient by the group's
    size."""
    return _PsumReplicated.apply(t, group)


def pmax(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of t over the group's ranks (a new tensor)."""
    return _all_reduce(t, group, dist.ReduceOp.MAX)


def all_gather_tiled(t: torch.Tensor, group) -> torch.Tensor:
    """[m, ...] per rank -> [n * m, ...], blocks in rank order."""
    t = t.detach().contiguous()
    n = axis_size(group)
    if n == 1:
        return t.clone()
    src = _to_host(t) if _staged(t, group) else t
    out = src.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(t.device)


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Overwrite t in place with group rank src's t."""
    if axis_size(group) == 1:
        return t
    if _staged(t, group):
        h = _to_host(t)
        dist.broadcast(h, dist.get_global_rank(group, src), group=group)
        t.copy_(h)
        return t
    dist.broadcast(t, dist.get_global_rank(group, src), group=group)
    return t
