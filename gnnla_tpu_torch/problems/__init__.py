"""Problem generators (host numpy/scipy assembly)."""

from gnnla_tpu_torch.problems.fem_heateqn import (heateqn_fem_2d,
                                                  stretched_mesh_matrix)
from gnnla_tpu_torch.problems.laplacian import laplacian_2d
from gnnla_tpu_torch.problems.small_band import (small_band_matrix,
                                                 small_band_matrix_host)

__all__ = ["laplacian_2d", "small_band_matrix", "small_band_matrix_host",
           "heateqn_fem_2d", "stretched_mesh_matrix"]
