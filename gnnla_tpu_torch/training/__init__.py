"""Training of the two learned models (the Jacobi smoother and the
diffusion-coefficient GNN): datasets, the spectral loss, the trainers and
parameter files."""

from gnnla_tpu_torch.training import spectral_loss
from gnnla_tpu_torch.training.datasets import (StackedGraphs,
                                               constant_diffusion_dataset,
                                               cosine_diffusion_dataset,
                                               diffusion_data_module,
                                               frequency_study_dataset,
                                               small_band_dataset,
                                               stretched_mesh_dataset)
from gnnla_tpu_torch.training.train_diffusion import TrainDiffusionConfig
from gnnla_tpu_torch.training.train_diffusion import train as train_diffusion
from gnnla_tpu_torch.training.train_jacobi import (TrainJacobiConfig,
                                                   evaluate_vs_baselines)
from gnnla_tpu_torch.training.train_jacobi import train as train_jacobi

__all__ = ["spectral_loss", "StackedGraphs", "small_band_dataset",
           "cosine_diffusion_dataset", "constant_diffusion_dataset",
           "frequency_study_dataset", "diffusion_data_module",
           "stretched_mesh_dataset",
           "TrainJacobiConfig", "train_jacobi", "evaluate_vs_baselines",
           "TrainDiffusionConfig", "train_diffusion"]
