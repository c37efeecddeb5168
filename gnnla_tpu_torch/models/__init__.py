"""Solver compositions: residual, Jacobi, Chebyshev, the two-grid V-cycle
(the fused forms) and its grid paths, the multilevel hierarchies and the
Krylov solvers; the learned Jacobi diagonal."""

from gnnla_tpu_torch.models.chebyshev import chebyshev
from gnnla_tpu_torch.models.geometric import (GeometricVCycle,
                                              make_geometric_vcycle)
from gnnla_tpu_torch.models.jacobi import jacobi
from gnnla_tpu_torch.models.krylov import amg_pcg, cg, mg_pcg
from gnnla_tpu_torch.models.multigrid import (MultigridSetup,
                                              multigrid_cycle,
                                              multigrid_solve,
                                              setup_multigrid,
                                              setup_sa_multigrid,
                                              setup_with_dia_multigrid)
from gnnla_tpu_torch.models.residual import residual
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
    "residual", "jacobi", "chebyshev",
    "TwoGridSetup", "setup_twogrid", "setup_from_numpy", "setup_with_dia",
    "setup_with_stream", "setup_with_stream_p", "setup_auto", "AutoTwoGrid",
    "vcycle", "solve", "StencilVCycle", "make_stencil_vcycle",
    "GeometricVCycle", "make_geometric_vcycle",
    "MultigridSetup", "setup_multigrid", "setup_sa_multigrid",
    "setup_with_dia_multigrid", "multigrid_cycle", "multigrid_solve",
    "cg", "amg_pcg", "mg_pcg",
    "TrainableJacobiMLP", "init_params", "jacobi_diag_features",
    "jacobi_diag_features_banded", "predict_diag",
]
