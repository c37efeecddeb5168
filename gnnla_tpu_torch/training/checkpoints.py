"""Parameter files — the counterpart of gnnla_tpu/training/checkpoints.py.

The JAX package stores a trained model as a flat npz of its flax parameter
tree, one array per leaf keyed by the leaf's path
("['params']['Dense_0']['kernel']"), as `artifacts/jacobi/params.npz` is.
`params_from_jax` carries such a tree (or file) across into the state dict
of the port's `TrainableJacobiMLP`. Training checkpoints are `torch.save`
files where the JAX package used orbax.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch


def _key(i: int, leaf: str) -> str:
    return f"['params']['Dense_{i}']['{leaf}']"


def params_from_jax(tree_or_npz) -> "OrderedDict[str, torch.Tensor]":
    """The state dict of a TrainableJacobiMLP from the JAX package's
    parameters: a path to (or the mapping of) a `save_params_npz` file, or
    the nested tree {'params': {'Dense_i': {'kernel', 'bias'}}} itself.
    Flax kernels are [in, out]; `nn.Linear` weights are [out, in]."""
    src = tree_or_npz
    if isinstance(src, (str, os.PathLike)):
        with np.load(src) as z:
            src = {k: z[k] for k in z.files}
    if "params" in src:  # the nested tree
        src = {_key(int(name.split("_")[1]), leaf): arr
               for name, layer in src["params"].items()
               for leaf, arr in layer.items()}
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    i = 0
    while _key(i, "kernel") in src:
        kernel = np.asarray(src[_key(i, "kernel")], np.float32)
        bias = np.asarray(src[_key(i, "bias")], np.float32)
        out[f"layers.{i}.weight"] = torch.from_numpy(kernel.T.copy())
        out[f"layers.{i}.bias"] = torch.from_numpy(bias.copy())
        i += 1
    if not out:
        raise ValueError("no Dense_i kernels found: not a flax MLP "
                         "parameter tree")
    return out


def load_params_npz(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a JAX-format npz into `model` (in place); returns it."""
    model.load_state_dict(params_from_jax(path))
    return model


def save_checkpoint(path: str, model: torch.nn.Module,
                    metrics: Mapping[str, float]) -> None:
    """One training checkpoint: the state dict and its metrics."""
    torch.save({"model": model.state_dict(), "metrics": dict(metrics)},
               path)


def load_checkpoint(path: str, model: torch.nn.Module) -> dict:
    """Load a `save_checkpoint` file into `model`; returns its metrics."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["model"])
    return ckpt["metrics"]
