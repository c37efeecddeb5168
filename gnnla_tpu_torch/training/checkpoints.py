"""Parameter files — the counterpart of gnnla_tpu/training/checkpoints.py.

The JAX package stores a trained model as a flat npz of its flax parameter
tree, one array per leaf keyed by the leaf's path
("['params']['Dense_0']['kernel']"), as `artifacts/jacobi/params.npz` is.
`params_from_jax` carries such a tree (or file) across into the state dict
of the port's `TrainableJacobiMLP`; `diffusion_params_from_jax` carries a
`DiffusionGNN` tree ("['params']['gn0_edge']['Dense_0']['kernel']") into
the state dict of the port's `DiffusionGNN`, and `save_diffusion_params_npz`
writes one back in that format, which the JAX package's `load_params_npz`
reads. Training checkpoints are `torch.save` files where the JAX package
used orbax.
"""

from __future__ import annotations

import os
import re
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


_DENSE_KEY = re.compile(
    r"^\['params'\]\['(\w+)'\]\['Dense_(\d+)'\]\['(kernel|bias)'\]$")


def _flat_jax(tree_or_npz) -> dict:
    """{"['params']['<module>']['Dense_i']['kernel'|'bias']": array} from a
    `save_params_npz` path, its mapping, or the nested tree."""
    src = tree_or_npz
    if isinstance(src, (str, os.PathLike)):
        with np.load(src) as z:
            return {k: z[k] for k in z.files}
    if "params" in src:
        return {f"['params']['{mod}']['{dense}']['{leaf}']": arr
                for mod, denses in src["params"].items()
                for dense, leaves in denses.items()
                for leaf, arr in leaves.items()}
    return dict(src)


def diffusion_params_from_jax(tree_or_npz
                              ) -> "OrderedDict[str, torch.Tensor]":
    """The state dict of a `DiffusionGNN` from the JAX package's
    parameters (a `save_params_npz` path or mapping, or the nested tree):
    flax module `m`'s `Dense_i` becomes `m.layers.i`, its [in, out]
    kernel transposed to `nn.Linear`'s [out, in]."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for key, arr in sorted(_flat_jax(tree_or_npz).items()):
        m = _DENSE_KEY.match(key)
        if m is None:
            raise ValueError(f"not a flax Dense parameter: {key!r}")
        mod, i, leaf = m.groups()
        arr = np.asarray(arr, np.float32)
        name = "weight" if leaf == "kernel" else "bias"
        out[f"{mod}.layers.{i}.{name}"] = torch.from_numpy(
            (arr.T if leaf == "kernel" else arr).copy())
    return out


def diffusion_params_to_jax(model_or_state) -> dict:
    """The inverse of `diffusion_params_from_jax`: the flat
    `save_params_npz` mapping of a DiffusionGNN (or its state dict)."""
    state = model_or_state
    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    out = {}
    for name, t in state.items():
        mod, layers, i, leaf = name.split(".")
        if layers != "layers":
            raise ValueError(f"not an MLPStack parameter: {name!r}")
        arr = t.detach().cpu().numpy().astype(np.float32)
        jleaf = "kernel" if leaf == "weight" else "bias"
        out[f"['params']['{mod}']['Dense_{i}']['{jleaf}']"] = \
            arr.T.copy() if jleaf == "kernel" else arr
    return out


def save_diffusion_params_npz(path: str, model_or_state) -> None:
    """One npz in the JAX package's `save_params_npz` format, which its
    `load_params_npz` reads."""
    np.savez_compressed(path, **diffusion_params_to_jax(model_or_state))


def load_diffusion_params_npz(path: str, model: torch.nn.Module
                              ) -> torch.nn.Module:
    """Load a JAX-format DiffusionGNN npz into `model` (in place)."""
    model.load_state_dict(diffusion_params_from_jax(path))
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
