"""Reproduce the reference's headline trainable-Jacobi result at full
scale on the port — the twin of the JAX repository's
scripts/reproduce_jacobi.py.

Reference pipeline (TrainableJacobiDiag/train.py): 1000 small-band
matrices (N=38, h_low=5e-4), 800/50/150 split, 62 epochs, batch 100, Adam
1e-2 + plateau, seed 54681; then the high-frequency eigen analysis over
the full 150-matrix test set (train.py:164-225), saved as
test_eigenvalues.npz.

Training runs on the card (or, asked for, the CPU), the dense eigen
analysis on the host. Writes under --out-dir:
  params.npz            trained model, in the JAX artifact's npz format
  history.json          loss curves + test loss + wall times
  test_eigenvalues.npz  the reference-layout eigen analysis (all 150)
  results.json          mean high-freq damping factors: learned vs
                        omega=1, 2/3, opt, and the device

Run: python -m gnnla_tpu_torch.scripts.reproduce_jacobi [--device cpu]
"""

from __future__ import annotations

import os
import time

import numpy as np

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.evaluation.eigen_analysis import eigen_analysis
from gnnla_tpu_torch.scripts._common import (CACHE_DIR, config_dict,
                                             device_line, highfreq_damping,
                                             jacobi_test_split, out_dir as
                                             make_out_dir, print_results,
                                             scale_split, write_json)
from gnnla_tpu_torch.training.checkpoints import save_params_npz
from gnnla_tpu_torch.training.datasets import small_band_dataset
from gnnla_tpu_torch.training.train_jacobi import (TrainJacobiConfig,
                                                   evaluate_vs_baselines,
                                                   train)


def jacobi_dataset(cfg, device):
    """The configuration's small-band dataset on `device` (cached)."""
    return small_band_dataset(cfg.num_matrices, n=cfg.n_mesh,
                              h_low=cfg.h_low, seed=cfg.seed,
                              cache_dir=cfg.cache_dir, device=device)


def pipeline(cfg: TrainJacobiConfig, ds, out_dir: str, device) -> dict:
    """Train, save, analyse the test split and write the results; returns
    them."""
    dev_line = device_line(device)
    t0 = time.time()
    model, history = train(cfg, dataset=ds, device=device)
    train_s = time.time() - t0
    history["total_train_s"] = train_s
    print(f"training: {train_s:.1f}s on {dev_line}", flush=True)

    save_params_npz(os.path.join(out_dir, "params.npz"), model)
    write_json(os.path.join(out_dir, "history.json"), history)

    te = jacobi_test_split(ds, cfg)
    # full 150-matrix eigen analysis (reference train.py:164-225)
    t0 = time.time()
    analysis = eigen_analysis(model, te, widths=cfg.widths,
                              init_scheme=cfg.init_scheme)
    np.savez_compressed(os.path.join(out_dir, "test_eigenvalues.npz"),
                        **analysis)
    print(f"eigen analysis over {te.n_graphs} matrices: "
          f"{time.time() - t0:.1f}s", flush=True)

    hf = highfreq_damping(analysis)
    # exact full-spectrum damping over the whole split (train.py:126-133)
    t0 = time.time()
    full = evaluate_vs_baselines(model.state_dict(), te, cfg)
    print(f"full-spectrum baselines over {te.n_graphs} matrices: "
          f"{time.time() - t0:.1f}s", flush=True)

    results = {
        "config": config_dict(cfg),
        "test_loss_gelfand": history.get("test_loss"),
        "highfreq_damping_mean": hf,
        "fullspectrum_damping_mean": full,
        "n_test_matrices": int(te.n_graphs),
        "train_seconds": train_s,
        "device": dev_line,
    }
    write_json(os.path.join(out_dir, "results.json"), results)
    return results


def main(out_dir: str = None, epochs: int = 62, num_matrices: int = 1000,
         device="cuda"):
    device = resolve_device(device)
    out_dir = make_out_dir(out_dir, "jacobi")
    cfg = TrainJacobiConfig(num_matrices=num_matrices, epochs=epochs,
                            loss_layout="dia", cache_dir=CACHE_DIR)
    scale_split(cfg)

    t0 = time.time()
    ds = jacobi_dataset(cfg, device)
    print(f"dataset: {ds.n_graphs} matrices, n_rows={ds.template.n_rows}, "
          f"nnz={ds.template.nnz} ({time.time() - t0:.1f}s)", flush=True)
    results = pipeline(cfg, ds, out_dir, device)

    hf, full = results["highfreq_damping_mean"], results[
        "fullspectrum_damping_mean"]
    print("\nRESULTS — mean high-frequency damping factor (lower is better)")
    for k in ("w1", "w23", "opt", "learned"):
        print(f"  {k:8s} {hf[k]:.5f}")
    print("full-spectrum:", {k: round(v, 5) for k, v in full.items()})
    ok = hf["learned"] < hf["w23"] and hf["learned"] < hf["w1"]
    print("learned beats w1 and w23 on high-freq damping:", ok)
    print_results(results)
    return results


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=62)
    p.add_argument("--num-matrices", type=int, default=1000)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    a = p.parse_args()
    main(a.out_dir, a.epochs, a.num_matrices, a.device)
