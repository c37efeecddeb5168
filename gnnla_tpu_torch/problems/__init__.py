"""Problem generators (host numpy/scipy assembly)."""

from gnnla_tpu_torch.problems.fem_heateqn import (heateqn_fem_2d,
                                                  stretched_mesh_matrix)
from gnnla_tpu_torch.problems.laplacian import (grid_coords_2d,
                                                laplacian_2d, laplacian_nd)
from gnnla_tpu_torch.problems.small_band import (small_band_matrix,
                                                 small_band_matrix_host)

__all__ = ["laplacian_2d", "laplacian_nd", "grid_coords_2d",
           "small_band_matrix", "small_band_matrix_host", "heateqn_fem_2d",
           "stretched_mesh_matrix"]
