"""What the artifact pipelines share: the output directories, the device
line, the Jacobi splits and the results line."""

from __future__ import annotations

import json
import os
import subprocess

import numpy as np
import torch

# the repository root: where the JAX package's committed results live
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
COMMITTED = os.path.join(ROOT, "artifacts")
# datasets are cached here, relative to the working directory, as the
# CLI's --cache-dir default
CACHE_DIR = "data_cache"
OUT_ROOT = os.path.join("runs", "torch_artifacts")


def out_dir(path, kind: str) -> str:
    """The output directory (`OUT_ROOT/kind` by default), made. Refuses
    a path inside `artifacts/`, which holds the JAX package's committed
    results."""
    path = path or os.path.join(OUT_ROOT, kind)
    real = os.path.realpath(path)
    if os.path.commonpath([real, os.path.realpath(COMMITTED)]) == \
            os.path.realpath(COMMITTED):
        raise ValueError(f"refusing to write under {COMMITTED}: it holds "
                         "the JAX package's committed artifacts; pass "
                         "another --out-dir")
    os.makedirs(path, exist_ok=True)
    return path


def device_line(device: torch.device) -> str:
    """The card's `name, power.limit` as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return lines[min(index, len(lines) - 1)].strip()


def config_dict(cfg) -> dict:
    """A trainer config's JSON-able fields, as the JAX scripts keep them."""
    return {k: v for k, v in vars(cfg).items()
            if isinstance(v, (int, float, str, bool, tuple, list))}


def scale_split(cfg) -> None:
    """Smoke runs (fewer than 1000 matrices): the 800/50/150 split scaled,
    as the JAX scripts do."""
    if cfg.num_matrices < 1000:
        cfg.n_train = max(1, int(cfg.num_matrices * 0.8))
        cfg.n_val = max(1, int(cfg.num_matrices * 0.05))
        cfg.n_test = cfg.num_matrices - cfg.n_train - cfg.n_val
        cfg.batch_size = min(cfg.batch_size, cfg.n_train)


def jacobi_test_split(ds, cfg):
    """The test split `train` derives from cfg.seed."""
    perm = np.random.default_rng(cfg.seed).permutation(ds.n_graphs)
    lo = cfg.n_train + cfg.n_val
    return ds.select(perm[lo:lo + cfg.n_test])


def highfreq_damping(analysis) -> dict:
    """Mean high-frequency damping factor (max |eval| of the restricted
    propagator) of each smoother."""
    return {k: float(np.mean(analysis[a].max(axis=1))) for k, a in (
        ("learned", "evals_learn_DinvA"), ("w1", "evals_DinvA"),
        ("w23", "evals_TwoThirds_DinvA"), ("opt", "evals_opt_DinvA"))}


def write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def print_results(results: dict) -> None:
    """The results JSON, compact, as the last stdout line."""
    print(json.dumps(results, separators=(",", ":")), flush=True)
