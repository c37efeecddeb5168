"""Post-training eigen analysis of the trainable Jacobi diagonal — the
counterpart of gnnla_tpu/evaluation/eigen_analysis.py.

The reference's TrainableJacobiDiag/train.py:136-225: for every test
matrix, the eigenvalues of the high-frequency restriction of the error
propagator I - M A for four smoothers M,

    D^-1           (omega = 1 Jacobi)
    (2/3) D^-1     (omega = 2/3 Jacobi)
    w* D^-1        (the spectrally optimal omega)
    (2/3) D_l^-1   (the learned diagonal)

and of I - A itself, saved as `test_eigenvalues.npz`. The learned
diagonal comes from the port's `TrainableJacobiMLP` on the dataset's
device; the dense eigenproblems are host float64 numpy, as in the JAX
package.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from gnnla_tpu_torch.models.trainable_jacobi import (TrainableJacobiMLP,
                                                     jacobi_diag_features)
from gnnla_tpu_torch.training.checkpoints import params_from_jax
from gnnla_tpu_torch.training.datasets import StackedGraphs, host_eig_map


def high_freq_modes(n_vertices: int, xy: np.ndarray) -> np.ndarray:
    """Normalised sin(tx pi x) sin(ty pi y) modes with tx > n/2 or
    ty > n/2 (reference train.py:136-146). Returns [N, n_modes]."""
    modes = []
    n = int(-1 + np.sqrt(1 + n_vertices))
    xy = np.asarray(xy, dtype=np.float64)
    for tx in range(1, n + 1):
        for ty in range(1, n + 1):
            if tx > n / 2 or ty > n / 2:
                t = np.sin(tx * np.pi * xy[:, 0]) * np.sin(ty * np.pi * xy[:, 1])
                nrm = np.linalg.norm(t)
                if nrm > 0:
                    modes.append(t / nrm)
    return np.stack(modes, axis=1)


def _restricted_evals(M_times_A: np.ndarray, modes: np.ndarray) -> np.ndarray:
    """sorted |eig| of (I - modes^T (M A) modes)."""
    k = modes.shape[1]
    evals = np.linalg.eigvals(np.eye(k) - modes.T @ M_times_A @ modes)
    return np.sort(np.abs(evals))


def _restricted_raw_evals(M_times_A: np.ndarray,
                          modes: np.ndarray) -> np.ndarray:
    """eig of modes^T (M A) modes; the restricted propagator for any omega
    follows as sorted |1 - omega * evals| (one decomposition serves
    omega = 1, 2/3 and the optimum)."""
    return np.linalg.eigvals(modes.T @ M_times_A @ modes)


def _mlp(params, widths, init_scheme, device) -> TrainableJacobiMLP:
    """A TrainableJacobiMLP on `device` from a model, a state dict, or the
    JAX package's parameters (a `save_params_npz` path, or its tree)."""
    if isinstance(params, TrainableJacobiMLP):
        return params
    if isinstance(params, (str, os.PathLike)) or "layers.0.weight" not in \
            params:
        params = params_from_jax(params)
    model = TrainableJacobiMLP(widths, init_scheme, device=device)
    model.load_state_dict(params)
    return model


def _analysis_row(job) -> Dict[str, np.ndarray]:
    """One test matrix's arrays (host float64): job = (rows, cols, vals,
    n, xy, d_learn, omega_learned)."""
    rows, cols, vals, n, xy, d_learn, omega_learned = job
    # the operator the JAX package densifies holds float32 values
    A = np.zeros((n, n))
    A[rows, cols] = vals.astype(np.float32)
    modes = high_freq_modes(n, xy)
    d = np.diag(A)
    out = {"evals_A": _restricted_evals(A, modes)}
    raw = _restricted_raw_evals(A / d[:, None], modes)
    out["evals_DinvA"] = np.sort(np.abs(1.0 - raw))
    out["evals_TwoThirds_DinvA"] = np.sort(np.abs(1.0 - (2.0 / 3.0) * raw))

    # w_opt from the spectrum of D^-1 A; for symmetric A through the
    # similar symmetric D^-1/2 A D^-1/2 (eigvalsh)
    if (d > 0).all() and np.allclose(A, A.T, rtol=0.0,
                                     atol=1e-12 * np.abs(A).max()):
        s = 1.0 / np.sqrt(d)
        evals_full = np.linalg.eigvalsh(A * s[:, None] * s[None, :])
    else:
        evals_full = np.linalg.eigvals(A / d[:, None]).real
    w_opt = 2.0 / (np.min(evals_full) + np.max(evals_full))
    out["evals_opt_DinvA"] = np.sort(np.abs(1.0 - w_opt * raw))
    out["diag_opt_Dinv"] = w_opt / d
    out["evals_learn_DinvA"] = _restricted_evals(
        omega_learned * A / d_learn[:, None], modes)
    out["diag_learn_Dinv"] = omega_learned / d_learn
    out["diag_A"] = d
    return out


def eigen_analysis(params, dataset: StackedGraphs, *,
                   widths=(50, 20, 1), init_scheme: str = "reference",
                   omega_learned: float = 2.0 / 3.0,
                   max_graphs: Optional[int] = None
                   ) -> Dict[str, np.ndarray]:
    """Dense high-frequency eigen analysis over a test bucket, the MLP on
    the dataset's device. `params`: a TrainableJacobiMLP, its state dict,
    or the JAX package's parameters (tree or npz path).

    Returns the arrays the reference saves: evals_A, evals_DinvA,
    evals_TwoThirds_DinvA, evals_opt_DinvA, evals_learn_DinvA, diag_A,
    diag_opt_Dinv, diag_learn_Dinv, hs, band_locs. The eigenproblems of
    many matrices run on a host pool (`datasets.host_eig_map`)."""
    if dataset.coords is None:
        raise ValueError("eigen analysis needs vertex coordinates")
    dev = dataset.template.device
    model = _mlp(params, widths, init_scheme, dev)
    n_graphs = dataset.n_graphs if max_graphs is None else min(
        dataset.n_graphs, max_graphs)
    rows, cols, _ = dataset.template.host_coo()
    n = dataset.template.n_rows

    jobs, hs, band_locs = [], [], []
    for i in range(n_graphs):
        feats = jacobi_diag_features(
            dataset.template_nodiag.with_values(
                dataset.offdiag_vals[i].astype(np.float32)),
            torch.from_numpy(dataset.diags[i].astype(np.float32)).to(dev))
        with torch.no_grad():
            d_learn = model(feats).double().cpu().numpy().ravel()
        jobs.append((rows, cols, dataset.vals[i], n, dataset.coords[i],
                     d_learn, omega_learned))
        if dataset.meta is not None:
            hs.append(dataset.meta.get("h", np.zeros(n_graphs))[i])
            band_locs.append(
                dataset.meta.get("band_loc", np.zeros(n_graphs))[i])

    per_graph = host_eig_map(_analysis_row, jobs)
    result = {k: np.stack([r[k] for r in per_graph])
              for k in ("evals_A", "evals_DinvA", "evals_TwoThirds_DinvA",
                        "evals_opt_DinvA", "evals_learn_DinvA", "diag_A",
                        "diag_opt_Dinv", "diag_learn_Dinv")}
    result["hs"] = np.asarray(hs)
    result["band_locs"] = np.asarray(band_locs)
    return result


def save_eigen_analysis(path: str, analysis: Dict[str, np.ndarray]) -> None:
    """np.savez, the layout of the reference's test_eigenvalues.npz."""
    np.savez(path, **analysis)


def load_eigen_analysis(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
