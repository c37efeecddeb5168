"""Frequency-study error surface of the diffusion GNN — the counterpart
of gnnla_tpu/evaluation/freq_study.py.

The reference's DiffCoeffs/Freq_Study.py:50-108: the trained model over
one matrix per (theta_x, theta_y) of the frequency grid, the training loss
per matrix arranged as an [F, F] surface.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from gnnla_tpu_torch.evaluation.ood import per_graph_losses
from gnnla_tpu_torch.models.diffusion_gnn import DiffusionGNN
from gnnla_tpu_torch.training.datasets import frequency_study_dataset
from gnnla_tpu_torch.training.train_diffusion import _model_device


def freq_study_errors(params, model: DiffusionGNN, *, n: int = 32,
                      max_freq: float = 4.0,
                      cache_dir=None) -> Tuple[np.ndarray, np.ndarray]:
    """(freqs [F], errors [F, F]) on the model's device: errors[ix, iy] is
    the loss at theta_x = freqs[ix], theta_y = freqs[iy]. `params` (a state
    dict) is loaded into `model` first unless None."""
    if params is not None:
        model.load_state_dict(params)
    ds = frequency_study_dataset(n=n, max_freq=max_freq, cache_dir=cache_dir,
                                 device=_model_device(model))
    losses = per_graph_losses(model, ds, n)
    thetas = ds.meta["thetas"]
    freqs = np.unique(thetas[:, 0])
    errors = np.zeros((freqs.shape[0], freqs.shape[0]))
    ix = np.searchsorted(freqs, thetas[:, 0])
    iy = np.searchsorted(freqs, thetas[:, 1])
    errors[ix, iy] = losses
    return freqs, errors
