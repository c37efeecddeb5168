"""Hyperparameter-grid evidence for the diffusion model on the port — the
twin of the JAX repository's scripts/grid_diffusion.py.

Runs the reference's top-5 combinations (DiffCoeffs/train.py:136-141; the
port's `cli.TOP_COMBOS`) through the same trainer on one shared dataset
(identical splits: the seed is shared) and records each combination's
val/test losses and the selected best (lowest val loss). Reduced scale,
as in the JAX script: 300 matrices at n = 48, 40 epochs, patience 12.

Writes grid.json under --out-dir.

Run: python -m gnnla_tpu_torch.scripts.grid_diffusion
"""

from __future__ import annotations

import os
import time

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.cli import TOP_COMBOS
from gnnla_tpu_torch.scripts._common import (CACHE_DIR, device_line,
                                             out_dir as make_out_dir,
                                             print_results, write_json)
from gnnla_tpu_torch.training.datasets import cosine_diffusion_dataset
from gnnla_tpu_torch.training.train_diffusion import (TrainDiffusionConfig,
                                                      train)


def combo_config(combo, num_matrices, n_mesh, epochs, patience
                 ) -> TrainDiffusionConfig:
    """The trainer's configuration of one TOP_COMBOS entry."""
    seed, enc, dec, n_ext, n_int, n_hidden = combo
    return TrainDiffusionConfig(
        num_matrices=num_matrices, n_mesh=n_mesh, max_freq=3.0,
        n_layers_external=n_ext, n_layers_internal=n_int,
        n_hidden=n_hidden, encoder=enc, decoder=dec, epochs=epochs,
        batch_size=64, seed=seed, patience=patience, cache_dir=CACHE_DIR,
        log_every=10)


def run_grid(ds, num_matrices, n_mesh, epochs, patience, device) -> dict:
    """Train every combination on the shared dataset; the grid dict of
    the JAX script (config, combos, best_index)."""
    combos_out = []
    for i, combo in enumerate(TOP_COMBOS):
        cfg = combo_config(combo, num_matrices, n_mesh, epochs, patience)
        enc, dec = cfg.encoder, cfg.decoder
        print(f"--- combo {i + 1}/{len(TOP_COMBOS)}: "
              f"ext={cfg.n_layers_external} int={cfg.n_layers_internal} "
              f"hidden={cfg.n_hidden} enc={enc} dec={dec}")
        t0 = time.time()
        _, hist = train(cfg, dataset=ds, device=device)
        combos_out.append({
            "n_layers_external": cfg.n_layers_external,
            "n_layers_internal": cfg.n_layers_internal,
            "n_hidden": cfg.n_hidden,
            "encoder": list(enc) if enc else [0, 0],
            "decoder": list(dec) if dec else [0, 0],
            "seed": cfg.seed,
            "val_loss": float(min(hist["val_loss"])),
            "test_loss": float(hist["test_loss"]),
            "epochs_run": len(hist["val_loss"]),
            "train_seconds": time.time() - t0,
        })

    best = min(range(len(combos_out)),
               key=lambda i: combos_out[i]["val_loss"])
    return {
        "config": {"num_matrices": num_matrices, "n_mesh": n_mesh,
                   "epochs": epochs, "patience": patience},
        "combos": combos_out,
        "best_index": best,
    }


def main(num_matrices=300, n_mesh=48, epochs=40, patience=12, out_dir=None,
         device="cuda"):
    device = resolve_device(device)
    out_dir = make_out_dir(out_dir, "diffusion")

    # one dataset for every combo: identical splits (cfg.seed is shared)
    ds = cosine_diffusion_dataset(num_matrices, n=n_mesh, max_freq=3.0,
                                  seed=41, cache_dir=CACHE_DIR,
                                  device=device)
    out = run_grid(ds, num_matrices, n_mesh, epochs, patience, device)
    out["device"] = device_line(device)
    path = os.path.join(out_dir, "grid.json")
    write_json(path, out)
    best = out["best_index"]
    print(f"wrote {path}; best = combo #{best + 1} "
          f"(val {out['combos'][best]['val_loss']:.5f})")
    print_results(out)
    return out


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--num-matrices", type=int, default=300)
    p.add_argument("--n-mesh", type=int, default=48)
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--patience", type=int, default=12)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    a = p.parse_args()
    main(a.num_matrices, a.n_mesh, a.epochs, a.patience, a.out_dir,
         a.device)
