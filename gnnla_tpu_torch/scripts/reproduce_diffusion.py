"""Reproduce the reference's best diffusion-coefficient model at full
scale on the port — the twin of the JAX repository's
scripts/reproduce_diffusion.py.

Reference pipeline (DiffCoeffs/train.py) with the best combination of
test_best_performing_model.py:51 — 1 external layer, 2 internal layers,
32 hidden, encoder (3,16), no decoder, seed 41, cosine diffusion, 1000
matrices, split 0.7/0.2/0.1, early stopping patience 20; then the
held-out test loss, the small-alpha OOD extrapolation
(test_best_performing_model.py:63-88) and the frequency-study surface
(Freq_Study.py:50-108). As in the JAX package, one fixed mesh resolution
n = 80 (one pattern bucket) instead of a random size per matrix.

Writes under --out-dir: params.npz (the JAX npz format), history.json,
ood.json, freq_study.npz, results.json (with the device).

Run: python -m gnnla_tpu_torch.scripts.reproduce_diffusion
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.evaluation.freq_study import freq_study_errors
from gnnla_tpu_torch.evaluation.ood import ood_extrapolation
from gnnla_tpu_torch.scripts._common import (CACHE_DIR, config_dict,
                                             device_line, out_dir as
                                             make_out_dir, print_results,
                                             write_json)
from gnnla_tpu_torch.training.checkpoints import save_diffusion_params_npz
from gnnla_tpu_torch.training.datasets import cosine_diffusion_dataset
from gnnla_tpu_torch.training.train_diffusion import (TrainDiffusionConfig,
                                                      train)


def flagship_config(epochs=200, num_matrices=1000, n_mesh=80
                    ) -> TrainDiffusionConfig:
    """The best combination of the reference's grid, as the JAX script
    trains it."""
    return TrainDiffusionConfig(
        num_matrices=num_matrices, n_mesh=n_mesh, max_freq=3.0,
        n_layers_external=1, n_layers_internal=2, n_hidden=32,
        encoder=(3, 16), decoder=None, epochs=epochs, batch_size=64,
        seed=41, patience=20, cache_dir=CACHE_DIR)


def evaluate(model, cfg):
    """(OOD sweep {alpha, loss}, freqs, errors [F, F]) of a trained model
    at the configuration's mesh size, on the model's device."""
    t0 = time.time()
    ood = ood_extrapolation(None, model, n=cfg.n_mesh,
                            cache_dir=cfg.cache_dir)
    print(f"OOD sweep ({time.time() - t0:.1f}s):", flush=True)
    for a, l in zip(ood["alpha"], ood["loss"]):
        print(f"  alpha={a:.1e}  loss={l:.5f}")
    t0 = time.time()
    freqs, errors = freq_study_errors(None, model, n=cfg.n_mesh,
                                      max_freq=4.0, cache_dir=cfg.cache_dir)
    print(f"freq study ({time.time() - t0:.1f}s): "
          f"{freqs.shape[0]}x{freqs.shape[0]} surface, "
          f"max log10 err {np.log10(errors.max()):.2f}", flush=True)
    return ood, freqs, errors


def pipeline(cfg: TrainDiffusionConfig, ds, out_dir: str, device) -> dict:
    """Train, save, evaluate and write the results; returns them."""
    dev_line = device_line(device)
    t0 = time.time()
    model, history = train(cfg, dataset=ds, device=device)
    train_s = time.time() - t0
    history["total_train_s"] = train_s
    print(f"training: {train_s:.1f}s on {dev_line}", flush=True)

    save_diffusion_params_npz(os.path.join(out_dir, "params.npz"), model)
    write_json(os.path.join(out_dir, "history.json"), history)

    ood, freqs, errors = evaluate(model, cfg)
    write_json(os.path.join(out_dir, "ood.json"),
               {k: np.asarray(v).tolist() for k, v in ood.items()})
    np.savez_compressed(os.path.join(out_dir, "freq_study.npz"),
                        freqs=freqs, errors=errors)

    results = {
        "config": config_dict(cfg),
        "test_loss": history.get("test_loss"),
        "best_val_loss": float(np.min(history["val_loss"])),
        "epochs_run": len(history["val_loss"]),
        "ood_loss_by_decade": {f"{a:.0e}": float(l)
                               for a, l in zip(ood["alpha"], ood["loss"])},
        "freq_study_mean_err": float(errors.mean()),
        "freq_study_max_err": float(errors.max()),
        "train_seconds": train_s,
        "device": dev_line,
    }
    write_json(os.path.join(out_dir, "results.json"), results)
    return results


def main(out_dir=None, epochs=200, num_matrices=1000, n_mesh=80,
         device="cuda"):
    device = resolve_device(device)
    out_dir = make_out_dir(out_dir, "diffusion")
    cfg = flagship_config(epochs, num_matrices, n_mesh)

    t0 = time.time()
    ds = cosine_diffusion_dataset(cfg.num_matrices, n=cfg.n_mesh,
                                  max_freq=cfg.max_freq, seed=cfg.seed,
                                  cache_dir=cfg.cache_dir, device=device)
    print(f"dataset: {ds.n_graphs} matrices, n_rows={ds.template.n_rows}, "
          f"nnz={ds.template.nnz} ({time.time() - t0:.1f}s)", flush=True)
    results = pipeline(cfg, ds, out_dir, device)
    print("\nRESULTS:", json.dumps(results, indent=1))
    print_results(results)
    return results


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--num-matrices", type=int, default=1000)
    p.add_argument("--n-mesh", type=int, default=80)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    a = p.parse_args()
    main(a.out_dir, a.epochs, a.num_matrices, a.n_mesh, a.device)
