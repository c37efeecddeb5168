"""Parameter files — the counterpart of gnnla_tpu/training/checkpoints.py.

The JAX package stores a trained model as a flat npz of its flax parameter
tree, one array per leaf keyed by the leaf's path
("['params']['Dense_0']['kernel']"), as `artifacts/jacobi/params.npz` is.
`params_from_jax` carries such a tree (or file) across into the state dict
of the port's `TrainableJacobiMLP`; `diffusion_params_from_jax` carries a
`DiffusionGNN` tree ("['params']['gn0_edge']['Dense_0']['kernel']") into
the state dict of the port's `DiffusionGNN`, and `save_diffusion_params_npz`
writes one back in that format, which the JAX package's `load_params_npz`
reads; `save_params_npz` writes either model in it. Training checkpoints
are `torch.save` files where the JAX package used orbax:
`CheckpointManager` keeps them with the JAX manager's methods and
retention rule.
"""

from __future__ import annotations

import os
import re
from collections import OrderedDict
from typing import List, Mapping, Optional, Tuple

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


def params_to_jax(model_or_state) -> dict:
    """The inverse of `params_from_jax`: the flat `save_params_npz`
    mapping of a TrainableJacobiMLP (or its state dict), [in, out]
    kernels."""
    state = model_or_state
    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    out = {}
    for name, t in state.items():
        layers, i, leaf = name.split(".")
        if layers != "layers":
            raise ValueError(f"not a TrainableJacobiMLP parameter: {name!r}")
        arr = t.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight":
            out[_key(int(i), "kernel")] = arr.T.copy()
        else:
            out[_key(int(i), "bias")] = arr
    return out


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


def save_params_npz(path: str, model_or_state) -> None:
    """One npz in the format of the JAX package's `save_params_npz`
    (gnnla_tpu/training/checkpoints.py:15), which its `load_params_npz`
    reads: a TrainableJacobiMLP as `artifacts/jacobi/params.npz` holds it
    ("['params']['Dense_i']['kernel']"), any other model of MLP stacks
    (a DiffusionGNN) as `save_diffusion_params_npz` writes it."""
    state = model_or_state
    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    if all(name.startswith("layers.") for name in state):
        arrays = params_to_jax(state)
    else:
        arrays = diffusion_params_to_jax(state)
    np.savez_compressed(path, **arrays)


def save_checkpoint(path: str, model, metrics: Mapping[str, float]) -> None:
    """One training checkpoint: the state dict (of a module, or given) and
    its metrics."""
    state = model.state_dict() if isinstance(model, torch.nn.Module) \
        else model
    torch.save({"model": state, "metrics": dict(metrics)}, path)


def load_checkpoint(path: str, model: torch.nn.Module) -> dict:
    """Load a `save_checkpoint` file into `model`; returns its metrics."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["model"])
    return ckpt["metrics"]


_CKPT_FILE = re.compile(r"^epoch_(\d+)\.pt$")


class CheckpointManager:
    """The counterpart of the JAX package's orbax `CheckpointManager`
    (gnnla_tpu/training/checkpoints.py:35): every step saved with its
    metrics, the best step by `val_loss` (lowest; a step without one
    ranks as inf), the latest step, restore of either, and `max_to_keep`.
    As orbax's best-N rule does, a full manager keeps the `max_to_keep`
    steps of lowest `val_loss` (of equal ones the later), which need not
    include the latest step.

    Each step is one `save_checkpoint` file, `epoch_<step:04d>.pt`, in
    `directory`; a manager opened on a directory takes up the steps
    already there."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._steps: List[Tuple[int, dict]] = []  # (step, metrics), by step
        for name in sorted(os.listdir(self.directory)):
            m = _CKPT_FILE.match(name)
            if m:
                ckpt = torch.load(os.path.join(self.directory, name),
                                  map_location="cpu", weights_only=True)
                self._steps.append((int(m.group(1)), ckpt["metrics"]))
        self._steps.sort(key=lambda sm: sm[0])

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"epoch_{step:04d}.pt")

    def _by_quality(self) -> List[int]:
        """Steps from worst to best (a stable sort: of equal metrics the
        later step ranks better, as in orbax)."""
        return [step for step, metrics in sorted(
            self._steps, key=lambda sm: sm[1].get("val_loss", float("inf")),
            reverse=True)]

    def save(self, step: int, state, metrics: Optional[dict] = None):
        """Save `state` (a module or a state dict) as `step`, then drop
        the steps the retention rule no longer keeps."""
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        save_checkpoint(self._path(step), state, metrics)
        self._steps = sorted([sm for sm in self._steps if sm[0] != step]
                             + [(step, metrics)], key=lambda sm: sm[0])
        if self.max_to_keep is not None \
                and len(self._steps) > self.max_to_keep:
            ranked = self._by_quality()
            keep = set(ranked[len(ranked) - self.max_to_keep:]
                       if self.max_to_keep else [])
            for s, _ in self._steps:
                if s not in keep:
                    os.remove(self._path(s))
            self._steps = [sm for sm in self._steps if sm[0] in keep]

    def restore(self, step: Optional[int] = None, template=None):
        """The state dict of `step` (default: the latest), loaded into
        `template` when a module is given (then the module is returned);
        None when no step is saved."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        state = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)["model"]
        if isinstance(template, torch.nn.Module):
            template.load_state_dict(state)
            return template
        return state

    def all_steps(self) -> List[int]:
        return [s for s, _ in self._steps]

    def best_step(self) -> Optional[int]:
        return self._by_quality()[-1] if self._steps else None

    def latest_step(self) -> Optional[int]:
        return self._steps[-1][0] if self._steps else None

    def close(self) -> None:
        """Nothing is left pending: every save is written when it
        returns."""
