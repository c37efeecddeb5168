"""Problem generators (host numpy/scipy assembly)."""

from gnnla_tpu_torch.problems.laplacian import laplacian_2d

__all__ = ["laplacian_2d"]
