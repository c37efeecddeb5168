"""Close the smoother loop on the port: the learned-D Jacobi inside a
two-grid cycle — the twin of the JAX repository's
scripts/smoother_twogrid.py.

On held-out small-band test matrices, the exact two-grid asymptotic
convergence factor, the spectral radius of

    E = S (I - P Ac^{-1} P^T A) S,   S = I - omega D^{-1} A  (1 pre, 1 post)

with the port's CLJP splitting + direct interpolation P, for D = the
learned diagonal, D = diag(A) at omega = 2/3 (the reference's evaluation
weight, TrainableJacobiDiag/train.py:203-205) and, when its parameters
exist, the stability-regularized D.

Reads the configuration from results.json and the parameters from
params.npz (required) and params_stable.npz (optional), all in
--params-dir (default: --out-dir; `artifacts/jacobi` carries the JAX
package's committed parameters across). Writes smoother_twogrid.json
under --out-dir.

Run: python -m gnnla_tpu_torch.scripts.smoother_twogrid
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.models.trainable_jacobi import (TrainableJacobiMLP,
                                                     jacobi_diag_features)
from gnnla_tpu_torch.models.vcycle import setup_twogrid
from gnnla_tpu_torch.scripts._common import (CACHE_DIR, device_line,
                                             jacobi_test_split, out_dir as
                                             make_out_dir, print_results,
                                             write_json)
from gnnla_tpu_torch.training.checkpoints import params_from_jax
from gnnla_tpu_torch.training.datasets import small_band_dataset
from gnnla_tpu_torch.training.train_jacobi import TrainJacobiConfig


def twogrid_rho(A_s, P_s, Ac_s, d, omega, k=400, seed=0):
    """Spectral radius of the exact two-grid iteration matrix
    E = S (I - P Ac^{-1} P^T A) S, estimated as the asymptotic growth
    rate (||E^k v|| / ||E^m v||)^(1/(k-m)) of a power iteration — robust
    to complex eigenvalue pairs, and O(k n nnz) instead of a dense eig.
    Host float64, identical to the JAX script's."""
    import scipy.sparse.linalg as spla

    rng = np.random.default_rng(seed)
    n = A_s.shape[0]
    winv = (omega / np.asarray(d, np.float64))
    Ac_lu = spla.splu(Ac_s.tocsc().astype(np.float64))
    A64 = A_s.astype(np.float64)
    P64 = P_s.astype(np.float64)

    def E(v):
        v = v - winv * (A64 @ v)                       # pre-smooth
        v = v - P64 @ Ac_lu.solve(P64.T @ (A64 @ v))   # exact coarse corr
        return v - winv * (A64 @ v)                    # post-smooth

    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    logs = []
    for _ in range(k):
        v = E(v)
        nv = np.linalg.norm(v)
        if nv == 0:
            return 0.0
        logs.append(np.log(nv))
        v /= nv
    m = k // 2  # discard transient; average the asymptotic growth rate
    return float(np.exp(np.mean(logs[m:])))


def load_config(params_dir: str) -> TrainJacobiConfig:
    """The Jacobi run's configuration from params_dir/results.json, with
    this package's dataset cache."""
    with open(os.path.join(params_dir, "results.json")) as f:
        jcfg = json.load(f)["config"]
    cfg = TrainJacobiConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                               for k, v in jcfg.items()})
    cfg.cache_dir = CACHE_DIR
    return cfg


def load_models(params_dir: str, cfg, device):
    """(learned MLP, stable MLP or None) from params_dir's npz files (the
    JAX package's format). A missing params.npz is an error."""
    path = os.path.join(params_dir, "params.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} is missing: run reproduce_jacobi first, or pass "
            "--params-dir with the trained parameters")
    models = []
    for name in ("params.npz", "params_stable.npz"):
        p = os.path.join(params_dir, name)
        if not os.path.exists(p):
            models.append(None)
            continue
        m = TrainableJacobiMLP(cfg.widths, cfg.init_scheme, device=device)
        m.load_state_dict(params_from_jax(p))
        models.append(m)
    return models[0], models[1]


def rho_table(te, model, model_stable, n_matrices: int = 30) -> dict:
    """The cycle rho of the learned, omega = 2/3 and (given a stable
    model) stable diagonals on the first n_matrices of the test split,
    printed per matrix; the summary dict of the JAX script."""
    dev = te.template.device
    omega = 2.0 / 3.0
    rows = []
    t0 = time.time()

    def learned_d(m, feats):
        with torch.no_grad():
            return m(feats).reshape(-1).double().cpu().numpy()

    for i in range(min(n_matrices, te.n_graphs)):
        op = te.template.with_values(te.vals[i].astype(np.float32))
        diag = np.asarray(te.diags[i], np.float64)
        feats = jacobi_diag_features(
            te.template_nodiag.with_values(
                te.offdiag_vals[i].astype(np.float32)),
            torch.from_numpy(te.diags[i].astype(np.float32)).to(dev))
        dlearn = learned_d(model, feats)

        setup = setup_twogrid(op, theta=0.25, splitting="cljp", seed=0)
        A_s = op.to_scipy().tocsr()
        P_s = setup.P.to_scipy().tocsr()
        Ac_s = setup.Ac.to_scipy().tocsr()
        rho_l = twogrid_rho(A_s, P_s, Ac_s, dlearn, omega)
        rho_b = twogrid_rho(A_s, P_s, Ac_s, diag, omega)
        rho_s = None
        if model_stable is not None:
            rho_s = twogrid_rho(A_s, P_s, Ac_s,
                                learned_d(model_stable, feats), omega)
        rows.append((rho_l, rho_b, rho_s))
        msg = f"matrix {i:3d}: rho learned {rho_l:.4f}  w23 {rho_b:.4f}"
        if rho_s is not None:
            msg += f"  stable {rho_s:.4f}"
        print(msg, flush=True)

    rho_l = np.array([r[0] for r in rows])
    rho_b = np.array([r[1] for r in rows])
    out = {
        "n_matrices": len(rows),
        "omega": omega,
        "n_pre": 1, "n_post": 1,
        "convfac_learned_mean": float(rho_l.mean()),
        "convfac_w23_mean": float(rho_b.mean()),
        "convfac_learned_max": float(rho_l.max()),
        "convfac_w23_max": float(rho_b.max()),
        "n_learned_better": int((rho_l < rho_b).sum()),
        "seconds": time.time() - t0,
    }
    if model_stable is not None:
        rho_s = np.array([r[2] for r in rows])
        out["convfac_stable_mean"] = float(rho_s.mean())
        out["convfac_stable_max"] = float(rho_s.max())
        out["n_stable_better_than_w23"] = int((rho_s < rho_b).sum())
    return out


def main(n_matrices=30, params_dir=None, out_dir=None, device="cuda"):
    device = resolve_device(device)
    out_dir = make_out_dir(out_dir, "jacobi")
    params_dir = params_dir or out_dir
    cfg = load_config(params_dir)
    model, model_stable = load_models(params_dir, cfg, device)
    ds = small_band_dataset(cfg.num_matrices, n=cfg.n_mesh, h_low=cfg.h_low,
                            seed=cfg.seed, cache_dir=cfg.cache_dir,
                            device=device)
    out = rho_table(jacobi_test_split(ds, cfg), model, model_stable,
                    n_matrices)
    out["device"] = device_line(device)
    path = os.path.join(out_dir, "smoother_twogrid.json")
    write_json(path, out)
    print(f"\nmean rho: learned {out['convfac_learned_mean']:.4f} vs "
          f"w23 {out['convfac_w23_mean']:.4f}"
          + (f" vs stable {out['convfac_stable_mean']:.4f}"
             if model_stable is not None else "")
          + f"; wrote {path}")
    print_results(out)
    return out


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--n-matrices", type=int, default=30)
    p.add_argument("--params-dir", default=None,
                   help="results.json, params.npz and params_stable.npz "
                        "(default: --out-dir)")
    p.add_argument("--out-dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    a = p.parse_args()
    main(a.n_matrices, a.params_dir, a.out_dir, a.device)
