"""Train the stability-regularized Jacobi diagonal on the port — the twin
of the JAX repository's scripts/reproduce_jacobi_stable.py.

The reference's pure high-frequency Gelfand loss yields a learned D whose
full-spectrum damping exceeds 1, so it diverges standalone and inside a
two-grid cycle. This script fine-tunes the same model with
`TrainJacobiConfig.stability_weight > 0`: an added penalty
w * relu(gelfand(random probes, deep k) - margin)^2 that forbids
amplification anywhere in the spectrum (an extension of the JAX package,
with no counterpart in the reference).

Warm-starts from <out-dir>/params.npz when it exists (the
reference-recipe parameters `reproduce_jacobi` writes there, in the JAX
npz format), then fine-tunes with the penalty active. Writes under
--out-dir: params_stable.npz, results_stable.json
(`smoother_twogrid` then adds the cycle-rho comparison).

Run: python -m gnnla_tpu_torch.scripts.reproduce_jacobi_stable
"""

from __future__ import annotations

import os
import time

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.evaluation.eigen_analysis import eigen_analysis
from gnnla_tpu_torch.scripts._common import (CACHE_DIR, config_dict,
                                             device_line, highfreq_damping,
                                             jacobi_test_split, out_dir as
                                             make_out_dir, print_results,
                                             scale_split, write_json)
from gnnla_tpu_torch.scripts.reproduce_jacobi import jacobi_dataset
from gnnla_tpu_torch.training.checkpoints import (params_from_jax,
                                                  save_params_npz)
from gnnla_tpu_torch.training.train_jacobi import (TrainJacobiConfig,
                                                   evaluate_vs_baselines,
                                                   train)


def stable_config(epochs=40, num_matrices=1000, weight=1.0, margin=1.22,
                  k_stab=10) -> TrainJacobiConfig:
    """The fine-tune's configuration (split scaled for smoke runs)."""
    cfg = TrainJacobiConfig(num_matrices=num_matrices, epochs=epochs,
                            loss_layout="dia", stability_weight=weight,
                            stability_margin=margin, stability_k=k_stab,
                            lr=3e-3, cache_dir=CACHE_DIR)
    scale_split(cfg)
    return cfg


def warm_start(out_dir: str):
    """The state dict of <out_dir>/params.npz (JAX npz format), or None."""
    ref_path = os.path.join(out_dir, "params.npz")
    if not os.path.exists(ref_path):
        return None
    print(f"warm-starting from {ref_path}", flush=True)
    return params_from_jax(ref_path)


def main(out_dir=None, epochs=40, num_matrices=1000, weight=1.0,
         margin=1.22, k_stab=10, device="cuda"):
    """Two-phase: warm-start from the reference-recipe parameters (phase
    1, the pure high-frequency loss), then fine-tune with the stability
    penalty active, pulling the diagonal back into the stable set from
    the good side of the trade-off."""
    device = resolve_device(device)
    out_dir = make_out_dir(out_dir, "jacobi")
    cfg = stable_config(epochs, num_matrices, weight, margin, k_stab)
    ds = jacobi_dataset(cfg, device)
    init_params = warm_start(out_dir)

    dev_line = device_line(device)
    t0 = time.time()
    model, history = train(cfg, dataset=ds, init_params=init_params,
                           device=device)
    train_s = time.time() - t0
    print(f"training: {train_s:.1f}s on {dev_line}", flush=True)
    save_params_npz(os.path.join(out_dir, "params_stable.npz"), model)

    te = jacobi_test_split(ds, cfg)
    analysis = eigen_analysis(model, te, widths=cfg.widths,
                              init_scheme=cfg.init_scheme)
    hf = highfreq_damping(analysis)
    full = evaluate_vs_baselines(model.state_dict(), te, cfg)

    results = {
        "config": config_dict(cfg),
        "test_loss_gelfand": history.get("test_loss"),
        "highfreq_damping_mean": hf,
        "fullspectrum_damping_mean": full,
        "n_test_matrices": int(te.n_graphs),
        "train_seconds": train_s,
        "device": dev_line,
    }
    write_json(os.path.join(out_dir, "results_stable.json"), results)
    print("high-freq damping:", {k: round(v, 4) for k, v in hf.items()})
    print("full-spectrum:    ", {k: round(v, 4) for k, v in full.items()})
    print("stable smoother:" if full["learned"] <= 1.05 else
          "STILL UNSTABLE:", full["learned"])
    print_results(results)
    return results


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--num-matrices", type=int, default=1000)
    p.add_argument("--weight", type=float, default=1.0)
    p.add_argument("--margin", type=float, default=1.22)
    p.add_argument("--stability-k", type=int, default=10)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    a = p.parse_args()
    main(a.out_dir, a.epochs, a.num_matrices, a.weight, a.margin,
         a.stability_k, a.device)
