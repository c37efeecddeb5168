"""The port's command-line drivers against the JAX package's on the CPU:
the hyperparameter grid and its listings, a Jacobi run with its eigen
analysis, a diffusion run, the refusal of a matrix count that leaves a
split empty, and the refusal to start without a card.

Both packages draw their initial parameters from their own generators,
so the port's trainers are started from the JAX package's initial
parameters (carried with `params_from_jax` / `diffusion_params_from_jax`)
wherever printed losses or learned arrays are compared.

Tolerances: listings identical; printed losses (5 decimals) within 1e-4
absolute; the eigen analysis's arrays that do not depend on the learned
diagonal within rtol 1e-10 (the same float64 eigensolves of identical
matrices), the learned ones as derived in `test_jacobi_eigen_analysis`.
"""

import importlib
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

from gnnla_tpu import cli as j_cli
from gnnla_tpu.core import GraphState as JState
from gnnla_tpu.models import diffusion_gnn as j_dg
from gnnla_tpu.models import trainable_jacobi as j_tj
from gnnla_tpu.training import datasets as j_ds
from gnnla_tpu_torch import cli as t_cli
from gnnla_tpu_torch.training.checkpoints import (diffusion_params_from_jax,
                                                  params_from_jax)

j_train_d = importlib.import_module("gnnla_tpu.training.train_diffusion")
t_train_d = importlib.import_module("gnnla_tpu_torch.training.train_diffusion")
t_train_j = importlib.import_module("gnnla_tpu_torch.training.train_jacobi")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUMBER = re.compile(r"-?\d+\.?\d*(?:e[+-]?\d+)?")
LOSS_ATOL = 1e-4  # printed with 5 decimals; the runs agree to ~1e-6


def jax_jacobi_init(cfg):
    """The initial MLP parameters of the JAX package's Jacobi `train`."""
    return j_tj.init_params(jax.random.PRNGKey(cfg.seed), widths=cfg.widths,
                            init_scheme=cfg.init_scheme)


def jax_diffusion_init(cfg):
    """The initial parameters of the JAX package's diffusion `train`
    (flax's init reads only the shapes of the bucket's first graph)."""
    ds = j_ds.cosine_diffusion_dataset(1, n=cfg.n_mesh, seed=cfg.seed)
    rel = j_train_d.edge_features(ds, cfg.n_mesh)
    e0 = np.concatenate([ds.offdiag_vals[0][:, None], rel], axis=1)
    s0 = JState(vertices=np.float32(ds.diags[0])[:, None],
                edges=np.float32(e0), globals_=np.float32(ds.globals_[0]))
    model = j_dg.DiffusionGNN(n_layers_external=cfg.n_layers_external,
                              n_layers_internal=cfg.n_layers_internal,
                              n_hidden=cfg.n_hidden, encoder=cfg.encoder,
                              decoder=cfg.decoder)
    return model.init(jax.random.PRNGKey(cfg.seed), ds.template_nodiag, s0)


def jacobi_from_jax_init(train):
    """`train` (the port's Jacobi trainer) started from the JAX package's
    initial parameters for the same configuration."""
    def run(cfg, *a, **kw):
        kw["init_params"] = params_from_jax(jax.tree.map(
            np.asarray, jax_jacobi_init(cfg)))
        return train(cfg, *a, **kw)
    return run


def diffusion_from_jax_init(train):
    """`train` (the port's diffusion trainer) started from the JAX
    package's initial parameters for the same configuration."""
    def run(cfg, *a, **kw):
        kw["init_params"] = diffusion_params_from_jax(jax.tree.map(
            np.asarray, jax_diffusion_init(cfg)))
        return train(cfg, *a, **kw)
    return run


def start_from_jax_inits(monkeypatch):
    """Make the port's two trainers, as the CLI calls them, start from the
    JAX package's initial parameters."""
    monkeypatch.setattr(t_train_j, "train", jacobi_from_jax_init(
        t_train_j.train))
    monkeypatch.setattr(t_train_d, "train", diffusion_from_jax_init(
        t_train_d.train))


def loss_numbers(out: str):
    """The numbers of the epoch and test-loss lines, in order."""
    lines = [ln for ln in out.splitlines()
             if ln.startswith(("epoch ", "test loss"))]
    # the Jacobi trainer appends the epoch's seconds "(0.1s)"
    return [float(v) for ln in lines
            for v in NUMBER.findall(re.sub(r"\([\d.]+s\)", "", ln))]


def test_grid_tables_identical():
    assert t_cli.TOP_COMBOS == j_cli.TOP_COMBOS
    assert t_cli.full_grid() == j_cli.full_grid()
    assert len(t_cli.full_grid()) == 432


@pytest.mark.parametrize("argv", [
    ["diffusion", "--num-combos"], ["diffusion", "--show-combos"],
    ["diffusion", "--full-grid", "--num-combos"],
    ["diffusion", "--full-grid", "--show-combos"]],
    ids=["num", "show", "full_num", "full_show"])
def test_listings_identical(capsys, argv):
    assert j_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert t_cli.main(argv) == 0
    assert capsys.readouterr().out == want


def test_jacobi_eigen_analysis(tmp_path, capsys, monkeypatch):
    """jacobi --num-matrices 1000 --n-mesh 5 --epochs 1 --eigen-analysis
    in both packages, the port from JAX's initial parameters.

    The arrays that do not involve the learned diagonal (eigenvalues of
    A, D^-1 A at omega 1, 2/3 and the optimum, diag A, the optimal D^-1)
    come from the same float64 eigensolves of identical matrices: rtol
    1e-10. The learned diagonal comes out of 8 Adam steps in f32; the
    packages' losses agree to ~1e-6 relative, and the MLP's outputs
    after the steps to ~1e-5 relative, so diag_learn_Dinv is held to
    rtol 1e-4 and the spectra of omega D_learn^-1 A — eigenvalues move by
    at most ||delta(D^-1)|| ||A|| — to 1e-4 of their largest value."""
    common = ["jacobi", "--num-matrices", "1000", "--n-mesh", "5",
              "--epochs", "1"]
    j_npz, t_npz = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    assert j_cli.main(common + ["--cache-dir", str(tmp_path / "jc"),
                                "--eigen-analysis", j_npz]) == 0
    j_out = capsys.readouterr().out
    start_from_jax_inits(monkeypatch)
    assert t_cli.main(common + ["--cache-dir", str(tmp_path / "tc"),
                                "--eigen-analysis", t_npz,
                                "--device", "cpu"]) == 0
    t_out = capsys.readouterr().out
    np.testing.assert_allclose(loss_numbers(t_out), loss_numbers(j_out),
                               rtol=0, atol=LOSS_ATOL)
    assert f"eigen analysis saved to {t_npz}" in t_out
    with np.load(j_npz) as jz, np.load(t_npz) as tz:
        assert sorted(tz.files) == sorted(jz.files)
        for k in jz.files:
            a, b = jz[k], tz[k]
            assert a.shape == b.shape, k
            if "learn" not in k:
                np.testing.assert_allclose(b, a, rtol=1e-10, err_msg=k)
            elif k == "diag_learn_Dinv":
                np.testing.assert_allclose(b, a, rtol=1e-4, err_msg=k)
            else:
                np.testing.assert_allclose(
                    b, a, rtol=0, atol=1e-4 * np.abs(a).max(), err_msg=k)


def test_diffusion_run_matches_jax(tmp_path, capsys, monkeypatch):
    """Combination 1 (the committed model's form) on 20 matrices at n = 8,
    2 epochs of batch 8 at the CLI's learning rate 1e-2: a run short and
    small enough to stay clear of the early overshoot of a wider net."""
    argv = ["diffusion", "--start-index", "1", "--end-index", "2",
            "--num-matrices", "20", "--n-mesh", "8", "--epochs", "2",
            "--batch-size", "8"]
    assert j_cli.main(argv + ["--cache-dir", str(tmp_path / "jc")]) == 0
    j_out = capsys.readouterr().out
    start_from_jax_inits(monkeypatch)
    assert t_cli.main(argv + ["--cache-dir", str(tmp_path / "tc"),
                              "--device", "cpu"]) == 0
    t_out = capsys.readouterr().out
    assert t_out.splitlines()[0] == j_out.splitlines()[0]  # the combo line
    want = loss_numbers(j_out)
    assert len(want) == 2 * 3 + 1  # two epochs of (epoch, train, val), test
    np.testing.assert_allclose(loss_numbers(t_out), want, rtol=0,
                               atol=LOSS_ATOL)


def test_empty_split_refused(tmp_path):
    """12 matrices leave the validation and test splits empty: the JAX
    CLI builds the data and crashes on the first empty split; the port
    refuses before it builds any data, naming the minimum."""
    argv = ["jacobi", "--num-matrices", "12", "--n-mesh", "5", "--epochs",
            "1"]
    with pytest.raises(ValueError):
        j_cli.main(argv + ["--cache-dir", str(tmp_path / "jc")])
    with pytest.raises(ValueError, match="at least 851 matrices"):
        t_cli.main(argv + ["--cache-dir", str(tmp_path / "tc"),
                           "--device", "cpu"])
    assert not (tmp_path / "tc").exists()
    # the smallest count that fills every split is taken
    cfg = t_train_j.TrainJacobiConfig(num_matrices=851)
    t_cli.check_jacobi_splits(cfg)
    with pytest.raises(ValueError, match="851"):
        t_cli.check_jacobi_splits(t_train_j.TrainJacobiConfig(
            num_matrices=850))


@pytest.mark.parametrize("argv", [
    ["jacobi", "--num-matrices", "1000", "--n-mesh", "5", "--epochs", "1"],
    ["diffusion", "--start-index", "1", "--end-index", "2",
     "--num-matrices", "20", "--n-mesh", "8", "--epochs", "1"]],
    ids=["jacobi", "diffusion"])
def test_no_card_without_device(tmp_path, argv):
    """Without --device the CLI runs on the card; with none visible it
    exits non-zero with the no-card message and builds no data."""
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "gnnla_tpu_torch.cli", *argv, "--cache-dir",
         str(tmp_path / "cache")], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert p.returncode != 0
    assert "no CUDA device is available" in p.stderr
    assert not (tmp_path / "cache").exists()
