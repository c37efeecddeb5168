"""The port's plots (`gnnla_tpu_torch/evaluation/viz.py`) against the JAX
package's on the CPU: each of the eight draws and saves, and what it
plots — scatter offsets, line data, bar and histogram heights, the
surface's face values — equals what the JAX function plots on the same
inputs (made from a numpy seed), exactly."""

import os
import subprocess
import sys

import numpy as np
import pytest

from gnnla_tpu.evaluation import viz as j_viz
from gnnla_tpu_torch.evaluation import viz as t_viz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _analysis(seed=0, n_mat=12, n_modes=9, n=16):
    """An analysis dict with eigen_analysis's keys and shapes."""
    rng = np.random.default_rng(seed)
    out = {k: np.sort(rng.uniform(0.2, 1.2, (n_mat, n_modes)), axis=1)
           for k in ("evals_A", "evals_DinvA", "evals_TwoThirds_DinvA",
                     "evals_opt_DinvA", "evals_learn_DinvA")}
    out["diag_A"] = rng.uniform(2.0, 6.0, (n_mat, n))
    out["diag_opt_Dinv"] = 0.7 / out["diag_A"]
    out["diag_learn_Dinv"] = out["diag_opt_Dinv"] * rng.uniform(
        0.8, 1.2, (n_mat, n))
    return out


HISTORY = {"train_loss": [0.9, 0.5, 0.31, 0.2],
           "val_loss": [1.0, 0.6, 0.4, 0.33], "test_loss": 0.3}
FREQS = np.linspace(0.0, 2.0, 5)
ERRORS = np.random.default_rng(3).uniform(1e-4, 1e-2, (5, 5))

CASES = {
    "eigenvalue_scatter": lambda v: v.eigenvalue_scatter(_analysis()),
    "damping_histograms": lambda v: v.damping_histograms(_analysis(1)),
    "damping_histograms_stacked": lambda v: v.damping_histograms(
        _analysis(1), stacked=True),
    "histograms_compared_to_learned":
        lambda v: v.histograms_compared_to_learned(_analysis(2)),
    "box_and_whisker": lambda v: v.box_and_whisker(_analysis(3)),
    "winners_plot": lambda v: v.winners_plot(_analysis(4)),
    "example_diag_profile": lambda v: v.example_diag_profile(_analysis(5),
                                                             idx=2),
    "plot_loss_history": lambda v: v.plot_loss_history(HISTORY),
    "plot_freq_surface": lambda v: v.plot_freq_surface(FREQS, ERRORS),
}


def plotted(fig):
    """What each axes shows: scatter offsets, line data, patch heights and
    the colour values of collections (a surface's faces)."""
    out = []
    for ax in fig.axes:
        for c in ax.collections:
            out.append(np.asarray(c.get_offsets()))
            if c.get_array() is not None:
                out.append(np.asarray(c.get_array()))
        out += [np.asarray(ln.get_xydata()) for ln in ax.lines]
        out += [np.asarray([p.get_x(), p.get_height()])
                for p in ax.patches]
        out.append(ax.get_xlabel())
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_plot_matches_jax_and_saves(case, tmp_path):
    import matplotlib.pyplot as plt

    fig_t, fig_j = CASES[case](t_viz), CASES[case](j_viz)
    try:
        got, want = plotted(fig_t), plotted(fig_j)
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            if isinstance(w, str):
                assert g == w
            else:
                np.testing.assert_array_equal(g, w)
    finally:
        plt.close(fig_t)
        plt.close(fig_j)
    # and each function writes the figure when given a path
    name = case.replace("_stacked", "")
    path = tmp_path / f"{case}.png"
    args = {"eigenvalue_scatter": (_analysis(),),
            "damping_histograms": (_analysis(1),),
            "histograms_compared_to_learned": (_analysis(2),),
            "box_and_whisker": (_analysis(3),),
            "winners_plot": (_analysis(4),),
            "example_diag_profile": (_analysis(5),),
            "plot_loss_history": (HISTORY,),
            "plot_freq_surface": (FREQS, ERRORS)}[name]
    plt.close(getattr(t_viz, name)(*args, save=str(path)))
    assert path.stat().st_size > 0


def test_matplotlib_is_imported_at_first_plot():
    code = ("import sys, gnnla_tpu_torch.evaluation; "
            "sys.exit(1 if 'matplotlib' in sys.modules else 0)")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
