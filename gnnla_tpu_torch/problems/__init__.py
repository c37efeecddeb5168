"""Problem generators (host numpy/scipy assembly)."""

from gnnla_tpu_torch.problems.diffusion_fem import (alpha_beta_targets,
                                                    constant_diffusion_matrix,
                                                    constant_field,
                                                    cosine_diffusion_matrix,
                                                    cosine_field)
from gnnla_tpu_torch.problems.fem_heateqn import (heateqn_fem_2d,
                                                  stretched_mesh_matrix)
from gnnla_tpu_torch.problems.laplacian import (grid_coords_2d,
                                                laplacian_2d, laplacian_nd)
from gnnla_tpu_torch.problems.quad_fem import (build_matrix_quads,
                                               structured_quads)
from gnnla_tpu_torch.problems.small_band import (small_band_matrix,
                                                 small_band_matrix_host)

__all__ = ["laplacian_2d", "laplacian_nd", "grid_coords_2d",
           "heateqn_fem_2d", "stretched_mesh_matrix", "build_matrix_quads",
           "structured_quads", "small_band_matrix", "small_band_matrix_host",
           "constant_diffusion_matrix", "cosine_diffusion_matrix",
           "alpha_beta_targets", "cosine_field", "constant_field"]
