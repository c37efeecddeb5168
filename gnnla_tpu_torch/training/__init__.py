"""Training of the learned Jacobi smoother: datasets, the spectral loss,
the trainer and parameter files."""

from gnnla_tpu_torch.training import spectral_loss
from gnnla_tpu_torch.training.datasets import (StackedGraphs,
                                               small_band_dataset)
from gnnla_tpu_torch.training.train_jacobi import (TrainJacobiConfig,
                                                   evaluate_vs_baselines)
from gnnla_tpu_torch.training.train_jacobi import train as train_jacobi

__all__ = ["spectral_loss", "StackedGraphs", "small_band_dataset",
           "TrainJacobiConfig", "train_jacobi", "evaluate_vs_baselines"]
