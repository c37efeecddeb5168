"""Out-of-distribution extrapolation of the diffusion GNN — the
counterpart of gnnla_tpu/evaluation/ood.py.

The reference's DiffCoeffs/test_best_performing_model.py:63-88: the
trained model on constant-diffusion matrices with alpha = 10^-i, far below
the training distribution, and beta = 0.8; the loss per decade.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gnnla_tpu_torch.models.diffusion_gnn import DiffusionGNN
from gnnla_tpu_torch.training.datasets import (constant_diffusion_dataset,
                                               periodic_rel_coords)
from gnnla_tpu_torch.training.train_diffusion import (_model_device,
                                                      loss_terms, make_apply)


def _f32(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev)


def per_graph_losses(model: DiffusionGNN, ds, n: int) -> np.ndarray:
    """`loss_terms` of each graph of an n x n periodic bucket, on the
    edge-order path (one batched forward on the model's device)."""
    dev = _model_device(model)
    apply_fn = make_apply(model, ds, periodic_rel_coords(
        ds.template_nodiag, n))
    with torch.no_grad():
        preds = apply_fn(_f32(ds.offdiag_vals, dev), _f32(ds.diags, dev),
                         _f32(ds.globals_, dev))
        y = _f32(ds.targets, dev)
        return np.array([float(loss_terms(preds[i], y[i]))
                         for i in range(ds.n_graphs)])


def ood_extrapolation(params, model: DiffusionGNN, *, n: int = 32,
                      n_decades: int = 6,
                      cache_dir=None) -> Dict[str, np.ndarray]:
    """Loss per alpha decade on the small-alpha / large-beta sweep, on the
    model's device; `params` (a state dict) is loaded into `model` first
    unless None. Returns {"alpha": [D], "loss": [D]}, alpha[i] = 10^-i,
    beta = 0.8."""
    if params is not None:
        model.load_state_dict(params)
    ds = constant_diffusion_dataset(n_decades, n=n,
                                    mode="small_alpha_large_beta",
                                    cache_dir=cache_dir,
                                    device=_model_device(model))
    return {"alpha": ds.meta["alpha"], "loss": per_graph_losses(model, ds, n)}
