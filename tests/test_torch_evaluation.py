"""The port's evaluation tools against the JAX package on the CPU: the
Jacobi smoother's dense eigen analysis (with its save/load round trip), and
the diffusion model's out-of-distribution sweep and frequency study.

The same inputs, made from numpy seeds, go through both packages; flax
parameter trees are carried across with `params_from_jax` and
`diffusion_params_from_jax`.

Tolerances: the non-learned eigen arrays (host float64 on the same float32
matrices) rtol 1e-10; the learned ones rtol 1e-5 (the MLP's f32 sums in
another order); losses rtol 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gnnla_tpu.core import GraphState as JState
from gnnla_tpu.evaluation.freq_study import freq_study_errors as j_freq
from gnnla_tpu.evaluation.ood import ood_extrapolation as j_ood
from gnnla_tpu.models import diffusion_gnn as j_dg
from gnnla_tpu.models import trainable_jacobi as j_tj
from gnnla_tpu.training import datasets as j_ds
from gnnla_tpu_torch.evaluation import freq_study_errors as t_freq
from gnnla_tpu_torch.evaluation import ood_extrapolation as t_ood
from gnnla_tpu_torch.models import diffusion_gnn as t_dg
from gnnla_tpu_torch.models.trainable_jacobi import TrainableJacobiMLP
from gnnla_tpu_torch.training import datasets as t_ds
from gnnla_tpu_torch.training.checkpoints import (diffusion_params_from_jax,
                                                  params_from_jax)

# the packages export the functions `eigen_analysis` and `train_diffusion`;
# the tests need the modules of the same names
j_eigen = importlib.import_module("gnnla_tpu.evaluation.eigen_analysis")
t_eigen = importlib.import_module("gnnla_tpu_torch.evaluation.eigen_analysis")
j_train = importlib.import_module("gnnla_tpu.training.train_diffusion")

CPU = "cpu"
EXACT = ("evals_A", "evals_DinvA", "evals_TwoThirds_DinvA",
         "evals_opt_DinvA", "diag_A", "diag_opt_Dinv", "hs", "band_locs")
LEARNED = ("evals_learn_DinvA", "diag_learn_Dinv")
DIFF_CFG = dict(n_layers_external=2, n_layers_internal=2, n_hidden=8,
                encoder=(2, 6), decoder=(1, 6))


@pytest.fixture(scope="module")
def jacobi_case():
    jd = j_ds.small_band_dataset(4, n=8, seed=0)
    td = t_ds.small_band_dataset(4, n=8, seed=0, device=CPU)
    params = j_tj.init_params(jax.random.PRNGKey(3))
    return jd, td, params


@pytest.mark.parametrize("source", ["tree", "state_dict", "model"])
def test_eigen_analysis_matches_jax(jacobi_case, source):
    jd, td, params = jacobi_case
    want = j_eigen.eigen_analysis(params, jd, max_graphs=2)
    tree = jax.tree.map(np.asarray, params)
    arg = {"tree": tree, "state_dict": params_from_jax(tree)}.get(source)
    if source == "model":
        arg = TrainableJacobiMLP(device=CPU)
        arg.load_state_dict(params_from_jax(tree))
    got = t_eigen.eigen_analysis(arg, td, max_graphs=2)
    assert set(got) == set(want)
    for k in EXACT:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10, atol=0,
                                   err_msg=k)
    for k in LEARNED:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   atol=1e-6 * np.abs(want[k]).max(),
                                   err_msg=k)


def test_eigen_analysis_save_load_and_npz_params(jacobi_case, tmp_path):
    jd, td, params = jacobi_case
    npz = str(tmp_path / "params.npz")
    from gnnla_tpu.training.checkpoints import save_params_npz
    save_params_npz(npz, params)
    got = t_eigen.eigen_analysis(npz, td, max_graphs=1)
    path = str(tmp_path / "eig.npz")
    t_eigen.save_eigen_analysis(path, got)
    loaded = t_eigen.load_eigen_analysis(path)
    assert set(loaded) == set(got)
    for k in got:
        np.testing.assert_array_equal(loaded[k], got[k])
    # each package reads the other's file
    j_loaded = j_eigen.load_eigen_analysis(path)
    for k in got:
        np.testing.assert_array_equal(j_loaded[k], got[k])


def test_high_freq_modes_and_restricted_evals_identical(jacobi_case):
    jd, _, _ = jacobi_case
    xy = jd.coords[0]
    modes = t_eigen.high_freq_modes(jd.template.n_rows, xy)
    np.testing.assert_array_equal(
        modes, j_eigen.high_freq_modes(jd.template.n_rows, xy))
    a = np.random.default_rng(0).standard_normal((modes.shape[0],) * 2)
    np.testing.assert_array_equal(t_eigen._restricted_evals(a, modes),
                                  j_eigen._restricted_evals(a, modes))
    np.testing.assert_array_equal(t_eigen._restricted_raw_evals(a, modes),
                                  j_eigen._restricted_raw_evals(a, modes))


def test_eigen_analysis_needs_coordinates():
    td = t_ds.cosine_diffusion_dataset(1, n=4, device=CPU)
    with pytest.raises(ValueError, match="coordinates"):
        t_eigen.eigen_analysis(TrainableJacobiMLP(device=CPU), td)


@pytest.fixture(scope="module")
def diffusion_case():
    n = 8
    jd = j_ds.cosine_diffusion_dataset(2, n=n, seed=1)
    rel = j_train.edge_features(jd, n)
    jm = j_dg.DiffusionGNN(**DIFF_CFG)
    e0 = jnp.concatenate([jnp.asarray(jd.offdiag_vals[0], jnp.float32)[:, None],
                          jnp.asarray(rel, jnp.float32)], axis=1)
    s0 = JState(vertices=jnp.asarray(jd.diags[0], jnp.float32)[:, None],
                edges=e0, globals_=jnp.asarray(jd.globals_[0], jnp.float32))
    params = jm.init(jax.random.PRNGKey(4), jd.template_nodiag, s0)
    state = diffusion_params_from_jax(jax.tree.map(np.asarray, params))
    return n, jm, params, state


def test_ood_extrapolation_matches_jax(diffusion_case):
    n, jm, params, state = diffusion_case
    want = j_ood(params, jm, n=n)
    model = t_dg.DiffusionGNN(**DIFF_CFG, device=CPU)
    got = t_ood(state, model, n=n)
    np.testing.assert_array_equal(got["alpha"], want["alpha"])
    assert got["loss"].shape == (6,)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    # params=None runs the model as it stands
    again = t_ood(None, model, n=n, n_decades=3)
    np.testing.assert_allclose(again["loss"], got["loss"][:3], rtol=1e-6)


def test_freq_study_errors_matches_jax(diffusion_case, tmp_path):
    n, jm, params, state = diffusion_case
    freqs_j, err_j = j_freq(params, jm, n=n, max_freq=2.0)
    model = t_dg.DiffusionGNN(**DIFF_CFG, device=CPU)
    freqs, err = t_freq(state, model, n=n, max_freq=2.0,
                        cache_dir=str(tmp_path))
    np.testing.assert_array_equal(freqs, freqs_j)
    assert err.shape == (5, 5) and (err > 0).all()
    np.testing.assert_allclose(err, err_j, rtol=1e-5)
    # the cached dataset gives the same surface
    _, err2 = t_freq(None, model, n=n, max_freq=2.0, cache_dir=str(tmp_path))
    np.testing.assert_array_equal(err2, err)


def test_evaluation_exports_match_jax():
    import gnnla_tpu.evaluation as je
    import gnnla_tpu_torch.evaluation as te
    assert sorted(te.__all__) == sorted(je.__all__)
