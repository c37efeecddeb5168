"""Plots of the learned models' evaluation (matplotlib, headless-safe) —
the port's own copy of gnnla_tpu/evaluation/viz.py.

Reference counterparts: TrainableJacobiDiag/data_viz.py:60-367 (plots over
test_eigenvalues.npz), DiffCoeffs/PlotLosses.py:42-78 (loss CSV -> pdf),
DiffCoeffs/Freq_Study.py:86-108 (3D error surface). Each function takes the
port's analysis dict (numpy arrays, from evaluation.eigen_analysis), a
training history or plain arrays, returns a matplotlib Figure, and
optionally writes it to `save`. matplotlib is imported at the first plot,
not with this module.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


_LABELS = {
    "evals_DinvA": r"$\omega=1$",
    "evals_TwoThirds_DinvA": r"$\omega=2/3$",
    "evals_opt_DinvA": r"$\omega=\omega^*$",
    "evals_learn_DinvA": "learned",
}


def eigenvalue_scatter(analysis: Dict[str, np.ndarray],
                       save: Optional[str] = None):
    """Max |eig| per matrix for each smoother, scattered against matrix
    index (data_viz.eigenvalue_scatter_plots)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    for key, label in _LABELS.items():
        ax.scatter(np.arange(analysis[key].shape[0]),
                   analysis[key].max(axis=1), s=12, label=label)
    ax.set_xlabel("test matrix")
    ax.set_ylabel("max |eig| on high-freq subspace")
    ax.legend()
    if save:
        fig.savefig(save, bbox_inches="tight")
    return fig


def damping_histograms(analysis: Dict[str, np.ndarray], *,
                       stacked: bool = False, save: Optional[str] = None):
    """Histograms of per-matrix damping factors
    (data_viz.seperate_histograms / stacked_histograms)."""
    plt = _plt()
    maxes = {label: analysis[key].max(axis=1)
             for key, label in _LABELS.items()}
    if stacked:
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.hist(list(maxes.values()), bins=20, stacked=True,
                label=list(maxes.keys()))
        ax.legend()
        ax.set_xlabel("damping factor")
    else:
        fig, axes = plt.subplots(len(maxes), 1, figsize=(8, 10),
                                 sharex=True)
        for ax, (label, vals) in zip(np.ravel(axes), maxes.items()):
            ax.hist(vals, bins=20)
            ax.set_title(label)
        axes[-1].set_xlabel("damping factor")
    if save:
        fig.savefig(save, bbox_inches="tight")
    return fig


def histograms_compared_to_learned(analysis: Dict[str, np.ndarray],
                                   save: Optional[str] = None):
    """Overlayed histogram of each classical smoother vs the learned one
    (data_viz.histograms_compared_to_learned)."""
    plt = _plt()
    learned = analysis["evals_learn_DinvA"].max(axis=1)
    classical = {k: v for k, v in _LABELS.items()
                 if k != "evals_learn_DinvA"}
    fig, axes = plt.subplots(len(classical), 1, figsize=(8, 9), sharex=True)
    for ax, (key, label) in zip(np.ravel(axes), classical.items()):
        ax.hist(analysis[key].max(axis=1), bins=20, alpha=0.6, label=label)
        ax.hist(learned, bins=20, alpha=0.6, label="learned")
        ax.legend()
    axes[-1].set_xlabel("damping factor")
    if save:
        fig.savefig(save, bbox_inches="tight")
    return fig


def box_and_whisker(analysis: Dict[str, np.ndarray],
                    save: Optional[str] = None):
    """Box plot of damping factors per smoother (data_viz.box_and_whisker)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    data = [analysis[k].max(axis=1) for k in _LABELS]
    ax.boxplot(data, tick_labels=list(_LABELS.values()))
    ax.set_ylabel("damping factor")
    if save:
        fig.savefig(save, bbox_inches="tight")
    return fig


def winners_plot(analysis: Dict[str, np.ndarray],
                 save: Optional[str] = None):
    """Bar chart of how often each smoother achieves the best damping
    factor (data_viz.winners_plot)."""
    plt = _plt()
    stackv = np.stack([analysis[k].max(axis=1) for k in _LABELS])
    winners = np.argmin(stackv, axis=0)
    counts = np.bincount(winners, minlength=len(_LABELS))
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.bar(list(_LABELS.values()), counts)
    ax.set_ylabel("# matrices won")
    if save:
        fig.savefig(save, bbox_inches="tight")
    return fig


def example_diag_profile(analysis: Dict[str, np.ndarray], idx: int = 0,
                         save: Optional[str] = None):
    """Learned vs optimal inverse-diagonal profile for one matrix
    (data_viz.example_diag_horizontal)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(9, 4))
    ax.plot(analysis["diag_opt_Dinv"][idx], label=r"$\omega^*/A_{ii}$")
    ax.plot(analysis["diag_learn_Dinv"][idx], label="learned")
    ax.set_xlabel("vertex")
    ax.set_ylabel(r"$M_{ii}$")
    ax.legend()
    if save:
        fig.savefig(save, bbox_inches="tight")
    return fig


def plot_loss_history(history: Dict[str, list],
                      save: Optional[str] = None):
    """train/val loss curves from a training-history dict
    (PlotLosses.py:42-78 analogue over our history instead of a CSV)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 5))
    for key in ("train_loss", "val_loss"):
        if key in history and len(history[key]):
            ax.plot(history[key], label=key)
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.set_yscale("log")
    ax.legend()
    if save:
        fig.savefig(save, bbox_inches="tight")
    return fig


def plot_freq_surface(freqs: np.ndarray, errors: np.ndarray,
                      save: Optional[str] = None):
    """3D log10-error surface over the frequency grid
    (Freq_Study.py:86-108)."""
    plt = _plt()
    from matplotlib import cm
    fig, ax = plt.subplots(subplot_kw={"projection": "3d"},
                           figsize=(10, 8))
    X, Y = np.meshgrid(2 * freqs, 2 * freqs, indexing="ij")
    ax.plot_surface(X, Y, np.log10(np.maximum(errors, 1e-30)),
                    cmap=cm.viridis)
    ax.set_xlabel(r"$\theta_{\alpha,x}$")
    ax.set_ylabel(r"$\theta_{\alpha,y}$")
    ax.set_zlabel("log10 MSE")
    if save:
        fig.savefig(save, bbox_inches="tight", pad_inches=1)
    return fig
