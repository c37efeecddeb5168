"""Data-parallel training over the ranks of a "data" mesh axis — what the
JAX trainers get from `jit` with the batch sharded over a 'data' axis and
the parameters replicated.

Every rank runs the same trainer on the same host data and the same
numpy draws; each takes its equal slice of every training batch, and
validation and test batches stay whole on every rank. A step's loss on a
rank is its slice's share of the global-batch loss (a surrogate whose
sum over the ranks is that loss), so the gradients all-reduced by SUM
are the gradient of the global-batch loss and every rank takes the same
Adam step. Parameters start equal: rank 0's are broadcast.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from gnnla_tpu_torch.parallel.collectives import (axis_index, axis_size,
                                                  broadcast_, psum)


class DataParallel:
    """The "data" axis of a trainer: its process group, size and this
    rank's index."""

    def __init__(self, group):
        self.group = group
        self.world = axis_size(group)
        self.rank = axis_index(group)

    @classmethod
    def from_args(cls, mesh, n_devices: Optional[int],
                  batch_size: int) -> Optional["DataParallel"]:
        """None without a mesh or n_devices; else the "data" axis of a
        DeviceMesh, or, for n_devices, the initialized process group of
        that size. Raises where neither fits, or where batch_size does not
        divide the axis."""
        if mesh is None and not n_devices:
            return None
        if mesh is not None:
            names = getattr(mesh, "mesh_dim_names", None)
            if not hasattr(mesh, "get_group") or "data" not in (names or ()):
                raise TypeError("mesh must be a torch.distributed "
                                "DeviceMesh with a 'data' axis, got "
                                f"{type(mesh).__name__}")
            group = mesh.get_group("data")
        else:
            if not dist.is_initialized():
                raise RuntimeError(
                    f"n_devices={n_devices} needs an initialized process "
                    "group of that size (parallel.initialize_distributed, "
                    "or torchrun)")
            if dist.get_world_size() != n_devices:
                raise RuntimeError(
                    f"n_devices={n_devices} but the process group has "
                    f"{dist.get_world_size()} ranks")
            group = dist.group.WORLD
        dp = cls(group)
        if batch_size % dp.world:
            raise ValueError(
                f"batch_size {batch_size} not divisible by the mesh's "
                f"{dp.world} devices")
        return dp

    def split(self, a):
        """This rank's equal slice of a batch's leading axis."""
        if a.shape[0] % self.world:
            raise ValueError(f"a batch of {a.shape[0]} does not split over "
                             f"{self.world} ranks")
        m = a.shape[0] // self.world
        return a[self.rank * m: (self.rank + 1) * m]

    def sync_parameters(self, model: torch.nn.Module) -> None:
        """Every rank takes rank 0's parameters."""
        with torch.no_grad():
            for p in model.parameters():
                broadcast_(p.data, 0, self.group)

    def sum_gradients(self, model: torch.nn.Module) -> None:
        """Each parameter's gradient summed over the ranks."""
        for p in model.parameters():
            if p.grad is not None:
                p.grad.copy_(psum(p.grad, self.group))

    def mean(self, value: torch.Tensor) -> torch.Tensor:
        """The mean of a per-rank value over the ranks."""
        return psum(value.detach(), self.group) / self.world
