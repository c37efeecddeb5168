"""The port's artifact pipelines (`gnnla_tpu_torch.scripts`) against the
JAX repository's scripts on the CPU, and the committed JAX artifacts'
data-only numbers recomputed by the JAX package on the CPU.

The data-only numbers (measured gaps to the committed artifacts, which
were written on a TPU host):
  * the high-frequency baselines (omega = 1, 2/3, opt) are means of
    `artifacts/jacobi/test_eigenvalues.npz`'s rows: equal to
    results.json's to 0; one of those rows recomputed here agrees to
    rtol 1e-8;
  * the full-spectrum baselines over the 150 test matrices, from the
    extreme eigenvalues of D^-1/2 A D^-1/2: gaps 2.8e-9 (omega = 1),
    6.6e-11 (2/3), 7.5e-11 (opt) — within the 1e-5 the chip run is held
    to;
  * the two-grid rho at omega = 2/3 over the first 30 test matrices:
    mean and max equal smoother_twogrid.json's bit for bit (gap 0, within
    the chip run's 1e-6). The artifact's learned and stable rho are
    bitwise JAX's on the CPU too (tests/test_torch_chip_constants.py).

The twins run at tiny sizes beside their JAX scripts, the port's trainers
started from the JAX package's initial parameters
(tests/test_torch_cli.py's helpers). Tolerances: histories, learned
damping factors and learned eigenvalues within 1e-4; baselines and the
non-learned eigen arrays within 1e-6 relative; JSON keys identical apart
from "device". The JAX `smoother_twogrid.py` and `grid_diffusion.py`
write into `artifacts/`, so their `main`s are never called: their
`twogrid_rho` is loaded by path, and the grid's combinations are held
against the JAX trainer directly.
"""

import contextlib
import hashlib
import importlib
import importlib.util
import io
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from gnnla_tpu.models.trainable_jacobi import (TrainableJacobiMLP as JMLP,
                                               jacobi_diag_features as
                                               j_features)
from gnnla_tpu.models.vcycle import setup_twogrid as j_setup_twogrid
from gnnla_tpu.ops.sparse import SparseOperator as JSparse
from gnnla_tpu.training import datasets as j_ds
from gnnla_tpu.training.checkpoints import load_params_npz as j_load
from gnnla_tpu.training.spectral_loss import dinv_a_spectrum
from gnnla_tpu.training.train_jacobi import TrainJacobiConfig as JJacobiCfg
from gnnla_tpu_torch.ops.sparse import SparseOperator as TSparse
from gnnla_tpu_torch.scripts import _common
from gnnla_tpu_torch.training import datasets as t_ds

from test_torch_cli import (diffusion_from_jax_init, jacobi_from_jax_init,
                            jax_diffusion_init)

j_train_d = importlib.import_module("gnnla_tpu.training.train_diffusion")
j_eigen = importlib.import_module("gnnla_tpu.evaluation.eigen_analysis")
t_repro_j = importlib.import_module(
    "gnnla_tpu_torch.scripts.reproduce_jacobi")
t_stable = importlib.import_module(
    "gnnla_tpu_torch.scripts.reproduce_jacobi_stable")
t_smoother = importlib.import_module(
    "gnnla_tpu_torch.scripts.smoother_twogrid")
t_repro_d = importlib.import_module(
    "gnnla_tpu_torch.scripts.reproduce_diffusion")
t_grid = importlib.import_module("gnnla_tpu_torch.scripts.grid_diffusion")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "artifacts", "jacobi")
OMEGA = 2.0 / 3.0
SMALL_JACOBI = 10   # matrices: an 8/1/1 split
HIST_ATOL = 1e-4


def jax_script(name):
    """A JAX script of scripts/ as a module (its `main` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jacobi_test_matrices(count: int):
    """The draws and host builds (scipy matrix, coords, band_loc) of the
    first `count` matrices of the test split of the JAX scripts' Jacobi
    dataset (1000 small-band matrices at n = 38, seed 54681): the draws of
    `small_band_dataset` and the split of `train`, only the needed
    matrices built, by the JAX package's generator."""
    cfg = JJacobiCfg()
    rng = np.random.default_rng(cfg.seed)
    h_high = 1.0 / (2 * (cfg.n_mesh - 2))
    args = [(cfg.n_mesh, (h_high - cfg.h_low) * rng.random() + cfg.h_low,
             0.9 * rng.random() + 0.05) for _ in range(cfg.num_matrices)]
    perm = np.random.default_rng(cfg.seed).permutation(cfg.num_matrices)
    lo = cfg.n_train + cfg.n_val
    picked = [args[i] for i in perm[lo:lo + count]]
    return picked, j_ds._parallel_map(j_ds._gen_small_band, picked)


def jax_jacobi_test_split(count: int):
    """`jacobi_test_matrices` stacked as the JAX package's bucket."""
    picked, built = jacobi_test_matrices(count)
    template, nodiag, vals, offdiag, diags = j_ds._stack_from_ops(
        [JSparse.from_scipy(K) for K, _, _ in built])
    return j_ds.StackedGraphs(
        template=template, template_nodiag=nodiag, vals=vals,
        offdiag_vals=offdiag, diags=diags,
        coords=np.stack([xy for _, xy, _ in built]),
        meta={"h": np.asarray([a[1] for a in picked]),
              "band_loc": np.asarray([bl for _, _, bl in built])})


def port_jacobi_test_split(count: int):
    """`jacobi_test_matrices` stacked as the port's bucket, on the CPU."""
    _, built = jacobi_test_matrices(count)
    template, nodiag, vals, offdiag, diags = t_ds._stack_from_ops(
        [TSparse.from_scipy(K, device="cpu") for K, _, _ in built], "cpu")
    return t_ds.StackedGraphs(
        template=template, template_nodiag=nodiag, vals=vals,
        offdiag_vals=offdiag, diags=diags,
        coords=np.stack([xy for _, xy, _ in built]))


def jax_twogrid_rhos(te, count, params_by_name):
    """Per matrix of the first `count`: {"w23": rho at diag(A), name: rho
    at the learned diagonal of each JAX parameter tree}, as the JAX
    smoother script computes them."""
    script = jax_script("smoother_twogrid")
    model = JMLP()
    out = {k: [] for k in ("w23", *params_by_name)}
    for i in range(count):
        op = te.template.with_values(jnp.asarray(te.vals[i], jnp.float32))
        setup = j_setup_twogrid(op, theta=0.25, splitting="cljp", seed=0)
        mats = (op.to_scipy().tocsr(), setup.P.to_scipy().tocsr(),
                setup.Ac.to_scipy().tocsr())
        out["w23"].append(script.twogrid_rho(
            *mats, np.asarray(te.diags[i], np.float64), OMEGA))
        feats = j_features(te.template_nodiag.with_values(
            jnp.asarray(te.offdiag_vals[i], jnp.float32)),
            jnp.asarray(te.diags[i], jnp.float32))
        for name, params in params_by_name.items():
            d = np.asarray(jnp.ravel(model.apply(params, feats)), np.float64)
            out[name].append(script.twogrid_rho(*mats, d, OMEGA))
    return {k: np.asarray(v) for k, v in out.items()}


def committed_jacobi_params(name="params.npz"):
    template = JMLP().init(jax.random.PRNGKey(0), jnp.zeros((1, 5)))
    return j_load(os.path.join(ARTIFACT, name), template)


def tree_digest(path):
    h = hashlib.sha256()
    for dirpath, _, files in sorted(os.walk(path)):
        for f in sorted(files):
            with open(os.path.join(dirpath, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    return h.hexdigest()


def load(path):
    with open(path) as f:
        return json.load(f)


def as_json(obj):
    return json.loads(json.dumps(obj))


def run_twin(main, *args, **kw):
    """(result, stdout) of a twin's main."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(*args, **kw)
    return out, buf.getvalue()


def assert_keys(port, jax_, what):
    assert set(port) - {"device"} == set(jax_), what
    assert port["device"] == "cpu", what


def close_hist(a, b):
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=HIST_ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(a["test_loss"], b["test_loss"], rtol=0,
                               atol=HIST_ATOL)


@pytest.fixture(scope="module")
def artifacts_digest():
    return tree_digest(os.path.join(ROOT, "artifacts"))


@pytest.fixture(scope="module")
def jacobi_runs(tmp_path_factory, artifacts_digest):
    """JAX's reproduce_jacobi and its stable fine-tune, and the twins:
    reproduce_jacobi from JAX's initial parameters, the stable twin
    warm-started from JAX's params.npz copied into its directory."""
    tmp = tmp_path_factory.mktemp("jacobi")
    jdir, pdir, sdir = (str(tmp / d) for d in ("jax", "port", "stable"))
    j_repro, j_stable = (jax_script("reproduce_jacobi"),
                         jax_script("reproduce_jacobi_stable"))
    with contextlib.redirect_stdout(io.StringIO()):
        j_repro.main(jdir, 2, SMALL_JACOBI)
        j_stable.main(jdir, 2, SMALL_JACOBI)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)  # the twins' relative dataset cache
        mp.setattr(t_repro_j, "train", jacobi_from_jax_init(t_repro_j.train))
        repro = run_twin(t_repro_j.main, pdir, 2, SMALL_JACOBI,
                         device="cpu")
        os.makedirs(sdir)
        shutil.copy(os.path.join(jdir, "params.npz"), sdir)
        stable = run_twin(t_stable.main, sdir, 2, SMALL_JACOBI, device="cpu")
    return dict(jdir=jdir, pdir=pdir, sdir=sdir, repro=repro, stable=stable)


# ------------------------------------------------ the committed artifacts
def test_committed_jacobi_baselines_reproduce_on_cpu():
    """The six baselines of artifacts/jacobi/results.json from the data
    alone: the high-frequency ones from the committed eigen arrays (one
    row recomputed by the JAX package here), the full-spectrum ones from
    the 150 test matrices rebuilt here, within 1e-5."""
    res = load(os.path.join(ARTIFACT, "results.json"))
    with np.load(os.path.join(ARTIFACT, "test_eigenvalues.npz")) as z:
        npz = {k: z[k] for k in z.files}
    hf = res["highfreq_damping_mean"]
    for k, arr in (("w1", "evals_DinvA"), ("w23", "evals_TwoThirds_DinvA"),
                   ("opt", "evals_opt_DinvA")):
        np.testing.assert_allclose(npz[arr].max(axis=1).mean(), hf[k],
                                   rtol=1e-12, err_msg=k)

    te = jax_jacobi_test_split(150)
    got = j_eigen.eigen_analysis(committed_jacobi_params(), te,
                                 max_graphs=1)
    for k in ("evals_A", "evals_DinvA", "evals_TwoThirds_DinvA",
              "evals_opt_DinvA", "diag_A", "diag_opt_Dinv", "hs",
              "band_locs"):
        np.testing.assert_allclose(got[k], npz[k][:1], rtol=1e-8,
                                   err_msg=k)

    # max |1 - w lam| over a real spectrum sits at its ends
    n = te.template.n_rows
    rows, cols = np.asarray(te.template.rows), np.asarray(te.template.cols)
    ends = []
    for i in range(te.n_graphs):
        A = sp.csr_matrix((te.vals[i].astype(np.float32).astype(np.float64),
                           (rows, cols)), shape=(n, n))
        s = sp.diags(1.0 / np.sqrt(np.asarray(te.diags[i], np.float64)))
        S = s @ A @ s
        ends.append((
            spla.eigsh(S, k=1, sigma=0, which="LM", tol=0,
                       return_eigenvectors=False)[0],
            spla.eigsh(S, k=1, which="LA", tol=0,
                       return_eigenvectors=False)[0]))
        if i < 2:  # the ends against the JAX package's whole spectrum
            lam = dinv_a_spectrum(te.template.with_values(
                jnp.asarray(te.vals[i], jnp.float32)), te.diags[i])
            np.testing.assert_allclose(ends[-1], (lam.min(), lam.max()),
                                       rtol=1e-10)
    lmin, lmax = np.asarray(ends).T
    full = res["fullspectrum_damping_mean"]
    for k, w in (("w1", 1.0), ("w23", OMEGA)):
        got_k = np.maximum(np.abs(1 - w * lmin), np.abs(1 - w * lmax))
        np.testing.assert_allclose(got_k.mean(), full[k], rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(((lmax - lmin) / (lmax + lmin)).mean(),
                               full["opt"], rtol=1e-5)


def test_committed_twogrid_w23_reproduces_on_cpu():
    """The omega = 2/3 cycle rho of smoother_twogrid.json: the data and
    the host AMG setup alone, within 1e-6 (measured: bit for bit)."""
    sm = load(os.path.join(ARTIFACT, "smoother_twogrid.json"))
    rho = jax_twogrid_rhos(jax_jacobi_test_split(30), 30, {})["w23"]
    np.testing.assert_allclose(rho.mean(), sm["convfac_w23_mean"],
                               rtol=1e-6)
    np.testing.assert_allclose(rho.max(), sm["convfac_w23_max"], rtol=1e-6)


# ------------------------------------------------------------- the twins
def test_twogrid_rho_matches_jax():
    """The twin's rho table on 3 test matrices with the committed
    parameters against the JAX script's `twogrid_rho`: omega = 2/3 within
    1e-9 relative, the learned and stable diagonals within 1e-4."""
    te_j = jax_jacobi_test_split(3)
    want = jax_twogrid_rhos(te_j, 3, {
        "learned": committed_jacobi_params(),
        "stable": committed_jacobi_params("params_stable.npz")})
    te_t = port_jacobi_test_split(3)
    cfg = t_smoother.load_config(ARTIFACT)
    model, model_s = t_smoother.load_models(ARTIFACT, cfg, "cpu")
    got, _ = run_twin(t_smoother.rho_table, te_t, model, model_s, 3)
    np.testing.assert_allclose(got["convfac_w23_mean"], want["w23"].mean(),
                               rtol=1e-9)
    np.testing.assert_allclose(got["convfac_w23_max"], want["w23"].max(),
                               rtol=1e-9)
    for name in ("learned", "stable"):
        np.testing.assert_allclose(got[f"convfac_{name}_mean"],
                                   want[name].mean(), rtol=1e-4)
        np.testing.assert_allclose(got[f"convfac_{name}_max"],
                                   want[name].max(), rtol=1e-4)
    assert got["n_matrices"] == 3


def test_reproduce_jacobi_twin(jacobi_runs):
    """Files, JSON keys, histories, learned damping within 1e-4, the
    baselines and non-learned eigen arrays within 1e-6 of the JAX
    script's; the port's params.npz read by the JAX loader; the results
    JSON printed last."""
    jdir, pdir = jacobi_runs["jdir"], jacobi_runs["pdir"]
    out, printed = jacobi_runs["repro"]
    for f in ("params.npz", "history.json", "test_eigenvalues.npz",
              "results.json"):
        assert os.path.exists(os.path.join(pdir, f)), f
    want, got = load(os.path.join(jdir, "results.json")), load(
        os.path.join(pdir, "results.json"))
    assert got == as_json(out) and json.loads(printed.splitlines()[-1]) == got
    assert_keys(got, want, "results.json")
    assert set(got["config"]) == set(want["config"])
    assert set(load(os.path.join(pdir, "history.json"))) == set(
        load(os.path.join(jdir, "history.json")))
    close_hist(load(os.path.join(pdir, "history.json")),
               load(os.path.join(jdir, "history.json")))
    for part in ("highfreq_damping_mean", "fullspectrum_damping_mean"):
        np.testing.assert_allclose(got[part]["learned"],
                                   want[part]["learned"], rtol=HIST_ATOL)
        for k in ("w1", "w23", "opt"):
            np.testing.assert_allclose(got[part][k], want[part][k],
                                       rtol=1e-6, err_msg=k)
    with np.load(os.path.join(pdir, "test_eigenvalues.npz")) as zp, \
            np.load(os.path.join(jdir, "test_eigenvalues.npz")) as zj:
        assert set(zp.files) == set(zj.files)
        for k in zj.files:
            learned = "learn" in k
            np.testing.assert_allclose(
                zp[k], zj[k], rtol=1e-4 if learned else 1e-6,
                atol=1e-6 if learned else 0.0, err_msg=k)
    template = JMLP().init(jax.random.PRNGKey(0), jnp.zeros((1, 5)))
    mine = j_load(os.path.join(pdir, "params.npz"), template)
    theirs = j_load(os.path.join(jdir, "params.npz"), template)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_reproduce_jacobi_stable_twin(jacobi_runs):
    """Warm-started from JAX's params.npz: the stable fine-tune's JSON
    keys, history and learned damping within 1e-4 of the JAX script's,
    its params_stable.npz read by the JAX loader."""
    jdir, sdir = jacobi_runs["jdir"], jacobi_runs["sdir"]
    out, printed = jacobi_runs["stable"]
    assert "warm-starting from" in printed
    want = load(os.path.join(jdir, "results_stable.json"))
    got = load(os.path.join(sdir, "results_stable.json"))
    assert got == as_json(out) and json.loads(printed.splitlines()[-1]) == got
    assert_keys(got, want, "results_stable.json")
    assert got["config"]["stability_weight"] == 1.0
    np.testing.assert_allclose(got["test_loss_gelfand"],
                               want["test_loss_gelfand"], atol=HIST_ATOL)
    for part in ("highfreq_damping_mean", "fullspectrum_damping_mean"):
        for k in ("learned", "w1", "w23", "opt"):
            np.testing.assert_allclose(
                got[part][k], want[part][k],
                rtol=HIST_ATOL if k == "learned" else 1e-6, err_msg=k)
    template = JMLP().init(jax.random.PRNGKey(0), jnp.zeros((1, 5)))
    j_load(os.path.join(sdir, "params_stable.npz"), template)


def test_smoother_twogrid_twin_main(jacobi_runs, tmp_path, monkeypatch):
    """The twin's main on the port's own small run: its config and both
    parameter files from --params-dir, rho on 1 matrix against the JAX
    `twogrid_rho`; a missing params.npz is an error."""
    monkeypatch.chdir(tmp_path)
    sdir, pdir = jacobi_runs["sdir"], jacobi_runs["pdir"]
    shutil.copy(os.path.join(pdir, "results.json"), sdir)
    out, printed = run_twin(t_smoother.main, 1, sdir,
                            str(tmp_path / "out"), "cpu")
    assert load(str(tmp_path / "out" / "smoother_twogrid.json")) == as_json(
        out)
    assert json.loads(printed.splitlines()[-1]) == as_json(out)
    assert set(out) - {"device"} == set(load(os.path.join(
        ARTIFACT, "smoother_twogrid.json")))
    cfg = t_smoother.load_config(sdir)
    ds = t_repro_j.jacobi_dataset(cfg, "cpu")
    te = _common.jacobi_test_split(ds, cfg)
    op = te.template.with_values(te.vals[0].astype(np.float32))
    setup = t_smoother.setup_twogrid(op, theta=0.25, splitting="cljp",
                                     seed=0)
    rho = jax_script("smoother_twogrid").twogrid_rho(
        op.to_scipy(), setup.P.to_scipy(), setup.Ac.to_scipy(),
        np.asarray(te.diags[0], np.float64), OMEGA)
    np.testing.assert_allclose(out["convfac_w23_mean"], rho, rtol=1e-12)
    bare = tmp_path / "bare"
    bare.mkdir()
    shutil.copy(os.path.join(pdir, "results.json"), bare)
    with pytest.raises(FileNotFoundError, match="params.npz"):
        t_smoother.main(1, str(bare), str(tmp_path / "out"), "cpu")


@pytest.fixture(scope="module")
def diffusion_runs(tmp_path_factory, artifacts_digest):
    tmp = tmp_path_factory.mktemp("diffusion")
    jdir, pdir = str(tmp / "jax"), str(tmp / "port")
    with contextlib.redirect_stdout(io.StringIO()):
        jax_script("reproduce_diffusion").main(jdir, 2, 16, 8)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        mp.setattr(t_repro_d, "train",
                   diffusion_from_jax_init(t_repro_d.train))
        port = run_twin(t_repro_d.main, pdir, 2, 16, 8, device="cpu")
    return jdir, pdir, port


def test_reproduce_diffusion_twin(diffusion_runs):
    """JSON keys, history, OOD sweep and frequency surface within 1e-4 of
    the JAX script's; the port's params.npz read by the JAX loader."""
    jdir, pdir, (out, printed) = diffusion_runs
    want, got = (load(os.path.join(d, "results.json")) for d in (jdir, pdir))
    assert got == as_json(out) and json.loads(printed.splitlines()[-1]) == got
    assert_keys(got, want, "results.json")
    assert set(got["config"]) == set(want["config"])
    close_hist(load(os.path.join(pdir, "history.json")),
               load(os.path.join(jdir, "history.json")))
    assert got["epochs_run"] == want["epochs_run"]
    assert got["ood_loss_by_decade"].keys() == want[
        "ood_loss_by_decade"].keys()
    for k, v in want["ood_loss_by_decade"].items():
        np.testing.assert_allclose(got["ood_loss_by_decade"][k], v,
                                   rtol=1e-4, err_msg=k)
    for k in ("freq_study_mean_err", "freq_study_max_err", "best_val_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert load(os.path.join(pdir, "ood.json")).keys() == load(
        os.path.join(jdir, "ood.json")).keys()
    with np.load(os.path.join(pdir, "freq_study.npz")) as zp, \
            np.load(os.path.join(jdir, "freq_study.npz")) as zj:
        np.testing.assert_array_equal(zp["freqs"], zj["freqs"])
        np.testing.assert_allclose(zp["errors"], zj["errors"], rtol=1e-4)
    cfg = j_train_d.TrainDiffusionConfig(
        **{k: (tuple(v) if isinstance(v, list) else v)
           for k, v in want["config"].items()})
    j_load(os.path.join(pdir, "params.npz"), jax_diffusion_init(cfg))


def test_grid_diffusion_twin(tmp_path, monkeypatch, artifacts_digest):
    """The twin's five combinations, 1 epoch on 16 matrices at n = 8,
    against the JAX trainer on the same configurations and dataset:
    val and test losses within 1e-4, best_index the argmin."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(t_grid, "train", diffusion_from_jax_init(
        t_grid.train))
    out, printed = run_twin(t_grid.main, 16, 8, 1, 12,
                            str(tmp_path / "out"), "cpu")
    assert load(str(tmp_path / "out" / "grid.json")) == as_json(out)
    assert json.loads(printed.splitlines()[-1]) == as_json(out)
    assert set(out) - {"device"} == set(load(os.path.join(
        ROOT, "artifacts", "diffusion", "grid.json")))
    jds = j_ds.cosine_diffusion_dataset(16, n=8, max_freq=3.0, seed=41)
    assert len(out["combos"]) == 5
    for combo, got in zip(t_grid.TOP_COMBOS, out["combos"]):
        cfg = t_grid.combo_config(combo, 16, 8, 1, 12)
        jcfg = j_train_d.TrainDiffusionConfig(**{
            k: v for k, v in vars(cfg).items()})
        jcfg.cache_dir, jcfg.log_every = None, 0
        with contextlib.redirect_stdout(io.StringIO()):
            _, hist = j_train_d.train(jcfg, dataset=jds)
        np.testing.assert_allclose(got["val_loss"], min(hist["val_loss"]),
                                   rtol=0, atol=HIST_ATOL)
        np.testing.assert_allclose(got["test_loss"], hist["test_loss"],
                                   rtol=0, atol=HIST_ATOL)
    vals = [c["val_loss"] for c in out["combos"]]
    assert out["best_index"] == int(np.argmin(vals))


@pytest.mark.parametrize("twin", [
    lambda d: t_repro_j.main(d, 1, SMALL_JACOBI, "cpu"),
    lambda d: t_stable.main(d, 1, SMALL_JACOBI, device="cpu"),
    lambda d: t_smoother.main(1, ARTIFACT, d, "cpu"),
    lambda d: t_repro_d.main(d, 1, 16, 8, "cpu"),
    lambda d: t_grid.main(16, 8, 1, 12, d, "cpu")],
    ids=["reproduce_jacobi", "stable", "smoother", "reproduce_diffusion",
         "grid"])
def test_twins_refuse_the_committed_artifacts(twin):
    for sub in ("jacobi", "diffusion"):
        with pytest.raises(ValueError, match="refusing to write"):
            twin(os.path.join(ROOT, "artifacts", sub))


def test_no_twin_wrote_under_artifacts(jacobi_runs, diffusion_runs,
                                       artifacts_digest):
    assert tree_digest(os.path.join(ROOT, "artifacts")) == artifacts_digest
