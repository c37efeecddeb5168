"""Solver compositions: the fixed kernels of the paper in their GN-block
forms (`*_gnn`, SOC, direct interpolation) and fused forms, the two-grid
V-cycle and its grid paths, the multilevel hierarchies and the Krylov
solvers; the learned Jacobi diagonal and the diffusion-coefficient
GNN."""

from gnnla_tpu_torch.models.chebyshev import chebyshev, chebyshev_gnn
from gnnla_tpu_torch.models.diffusion_gnn import (DiffusionGNN, MLPStack,
                                                  init_diffusion_gnn)
from gnnla_tpu_torch.models.direct_interp import direct_interp
from gnnla_tpu_torch.models.geometric import (GeometricVCycle,
                                              make_geometric_vcycle)
from gnnla_tpu_torch.models.jacobi import JacobiBlock, jacobi, jacobi_gnn
from gnnla_tpu_torch.models.krylov import amg_pcg, cg, mg_pcg
from gnnla_tpu_torch.models.matvec import MatVecBlock, matvec, matvec_gnn
from gnnla_tpu_torch.models.multigrid import (MultigridSetup,
                                              multigrid_cycle,
                                              multigrid_solve,
                                              setup_multigrid,
                                              setup_sa_multigrid,
                                              setup_with_dia_multigrid)
from gnnla_tpu_torch.models.norm import (WeightedNormBlock,
                                         matrix_weighted_norm,
                                         matrix_weighted_norm_gnn)
from gnnla_tpu_torch.models.power_method import (power_method,
                                                 power_method_gnn)
from gnnla_tpu_torch.models.residual import (ResidualBlock, residual,
                                             residual_gnn)
from gnnla_tpu_torch.models.soc import soc_classic, soc_classic_blocks, soc_sa
from gnnla_tpu_torch.models.trainable_jacobi import (
    TrainableJacobiMLP, init_params, jacobi_diag_features,
    jacobi_diag_features_banded, predict_diag)
from gnnla_tpu_torch.models.vcycle import (AutoTwoGrid, StencilVCycle,
                                           TwoGridSetup, make_stencil_vcycle,
                                           setup_auto, setup_from_numpy,
                                           setup_twogrid, setup_with_dia,
                                           setup_with_stream,
                                           setup_with_stream_p, solve, vcycle)

__all__ = [
    "matvec", "matvec_gnn", "MatVecBlock",
    "residual", "residual_gnn", "ResidualBlock",
    "matrix_weighted_norm", "matrix_weighted_norm_gnn", "WeightedNormBlock",
    "jacobi", "jacobi_gnn", "JacobiBlock",
    "chebyshev", "chebyshev_gnn",
    "power_method", "power_method_gnn",
    "soc_classic", "soc_sa", "soc_classic_blocks",
    "direct_interp",
    "TwoGridSetup", "setup_twogrid", "setup_from_numpy", "setup_with_dia",
    "setup_with_stream", "setup_with_stream_p", "setup_auto", "AutoTwoGrid",
    "vcycle", "solve", "StencilVCycle", "make_stencil_vcycle",
    "GeometricVCycle", "make_geometric_vcycle",
    "MultigridSetup", "setup_multigrid", "setup_sa_multigrid",
    "setup_with_dia_multigrid", "multigrid_cycle", "multigrid_solve",
    "cg", "amg_pcg", "mg_pcg",
    "TrainableJacobiMLP", "init_params", "jacobi_diag_features",
    "jacobi_diag_features_banded", "predict_diag",
    "DiffusionGNN", "MLPStack", "init_diffusion_gnn",
]
