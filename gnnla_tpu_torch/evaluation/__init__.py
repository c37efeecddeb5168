"""Evaluation tools of the two learned models: the Jacobi smoother's dense
eigen analysis, the diffusion model's out-of-distribution sweep and
frequency study; their plots are `evaluation.viz` (matplotlib at first
use), which the package does not re-export, as in the JAX package."""

from gnnla_tpu_torch.evaluation.eigen_analysis import (eigen_analysis,
                                                       high_freq_modes,
                                                       load_eigen_analysis,
                                                       save_eigen_analysis)
from gnnla_tpu_torch.evaluation.freq_study import freq_study_errors
from gnnla_tpu_torch.evaluation.ood import ood_extrapolation

__all__ = ["high_freq_modes", "eigen_analysis", "save_eigen_analysis",
           "load_eigen_analysis", "freq_study_errors", "ood_extrapolation"]
