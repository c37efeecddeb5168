"""The port's diffusion-coefficient model against the JAX package on the
CPU: the periodic diffusion FEM, the datasets and their caches, the
`DiffusionGNN` forward on every path, the committed artifact at full
width, the loss and its gradient, the trainer and the parameter files.

The same inputs, made from numpy seeds, go through both packages; flax
parameter trees are carried across with `diffusion_params_from_jax`.

Tolerances: host numpy (FEM, datasets) identical; forwards rtol 1e-5,
atol 1e-6 * max|y| (f32 sums in another order); the loss and its
gradient rtol 1e-4; training histories 1e-4 relative (the differences
compound through Adam).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnla_tpu.core import GraphState as JState
from gnnla_tpu.core.batch import batch_operators as j_batch_operators
from gnnla_tpu.models import diffusion_gnn as j_dg
from gnnla_tpu.ops import band as j_band
from gnnla_tpu.problems import diffusion_fem as j_fem
from gnnla_tpu.training import datasets as j_ds
from gnnla_tpu.training.checkpoints import load_params_npz as j_load_npz
from gnnla_tpu.training.checkpoints import save_params_npz as j_save_npz
from gnnla_tpu_torch.core import GraphState, batch_operators
from gnnla_tpu_torch.models import diffusion_gnn as t_dg
from gnnla_tpu_torch.ops import band as t_band
from gnnla_tpu_torch.problems import diffusion_fem as t_fem
from gnnla_tpu_torch.training import datasets as t_ds
from gnnla_tpu_torch.training.checkpoints import (diffusion_params_from_jax,
                                                  diffusion_params_to_jax,
                                                  load_diffusion_params_npz,
                                                  save_diffusion_params_npz)

# the packages export the function `train_diffusion`; the tests need the
# modules of the same name
j_train = importlib.import_module("gnnla_tpu.training.train_diffusion")
t_train = importlib.import_module("gnnla_tpu_torch.training.train_diffusion")

CPU = "cpu"
ARTIFACT = "artifacts/diffusion"
THETAS = (1.0, 0.5, 2.5, 1.5)
# 2 external layers (global update on), an encoder and a decoder
WIDE = dict(n_layers_external=2, n_layers_internal=2, n_hidden=8,
            encoder=(2, 6), decoder=(2, 6))
# the artifact's configuration (artifacts/diffusion/results.json)
ARTIFACT_CFG = dict(n_layers_external=1, n_layers_internal=2, n_hidden=32,
                    encoder=(3, 16))


def assert_close(got, want, rtol=1e-5, atol_scale=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * np.abs(want).max())


def f32j(a):
    return jnp.asarray(np.asarray(a), jnp.float32)


def f32t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def same_dataset(jd, td):
    for k in ("vals", "offdiag_vals", "diags", "coords", "targets",
              "globals_"):
        a, b = getattr(jd, k), getattr(td, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(b, a, err_msg=k)
    assert set(jd.meta) == set(td.meta)
    for k in jd.meta:
        np.testing.assert_array_equal(td.meta[k], jd.meta[k], err_msg=k)
    for jt, tt in ((jd.template, td.template),
                   (jd.template_nodiag, td.template_nodiag)):
        for a, b in zip(jt.host_coo()[:2], tt.host_coo()[:2]):
            np.testing.assert_array_equal(b, a)


def jax_init(model, ds, seed, n):
    """JAX's `train` initialisation on the bucket's first graph."""
    rel = j_train.edge_features(ds, n)
    e0 = jnp.concatenate([f32j(ds.offdiag_vals[0])[:, None], f32j(rel)],
                         axis=1)
    s0 = JState(vertices=f32j(ds.diags[0])[:, None], edges=e0,
                globals_=f32j(ds.globals_[0]))
    return model.init(jax.random.PRNGKey(seed), ds.template_nodiag, s0)


def port_model(cfg, params):
    model = t_dg.DiffusionGNN(**cfg, device=CPU)
    model.load_state_dict(diffusion_params_from_jax(
        jax.tree.map(np.asarray, params)))
    return model


# --------------------------------------------------------------------- FEM
@pytest.mark.parametrize("conv,refsym", [(None, False), ((0.1, 0.0), False),
                                         ((0.1, -0.2), True)])
def test_element_stiffness_identical(conv, refsym):
    args = dict(convection=conv, reference_symmetrized=refsym)
    np.testing.assert_array_equal(
        t_fem.element_stiffness_field(5, t_fem.cosine_field(1.5, 0.5),
                                      t_fem.cosine_field(2.0, 3.0), **args),
        j_fem.element_stiffness_field(5, j_fem.cosine_field(1.5, 0.5),
                                      j_fem.cosine_field(2.0, 3.0), **args))


def test_basis_and_index_map_identical():
    xi, nu = np.linspace(0, 1, 7), np.linspace(1, 0, 7)
    for a, b in zip(t_fem._basis_and_grads(xi, nu),
                    j_fem._basis_and_grads(xi, nu)):
        np.testing.assert_array_equal(a, b)
    for n in (3, 5):
        for k in range(n * n):
            np.testing.assert_array_equal(t_fem.element_to_index_map(k, n),
                                          j_fem.element_to_index_map(k, n))


@pytest.mark.parametrize("n", [4, 7])
def test_fem_triplets_and_targets_identical(n):
    ke = j_fem.element_stiffness_field(n, j_fem.constant_field(0.3),
                                       j_fem.constant_field(0.8))
    a, b = t_fem.assemble_periodic(ke, n), j_fem.assemble_periodic(ke, n)
    for x, y in ((a.row, b.row), (a.col, b.col), (a.data, b.data)):
        np.testing.assert_array_equal(x, y)
    t_op = t_fem.cosine_diffusion_matrix(THETAS, n, device=CPU)
    j_op = j_fem.cosine_diffusion_matrix(THETAS, n)
    for x, y in zip(t_op.host_coo(), j_op.host_coo()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(t_op.vals.numpy(), np.asarray(j_op.vals))
    t_c = t_fem.constant_diffusion_matrix(0.2, 0.9, n, device=CPU)
    j_c = j_fem.constant_diffusion_matrix(0.2, 0.9, n)
    for x, y in zip(t_c.host_coo(), j_c.host_coo()):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(t_fem.alpha_beta_targets(THETAS, n),
                    j_fem.alpha_beta_targets(THETAS, n)):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------- datasets
@pytest.mark.parametrize("conv", [None, (0.1, 0.0)])
def test_cosine_dataset_identical(conv):
    same_dataset(j_ds.cosine_diffusion_dataset(5, n=6, seed=3,
                                               convection=conv),
                 t_ds.cosine_diffusion_dataset(5, n=6, seed=3,
                                               convection=conv, device=CPU))


@pytest.mark.parametrize("mode", ["random", "small_alpha_large_beta"])
def test_constant_dataset_identical(mode):
    same_dataset(j_ds.constant_diffusion_dataset(4, n=5, mode=mode, seed=2),
                 t_ds.constant_diffusion_dataset(4, n=5, mode=mode, seed=2,
                                                 device=CPU))
    with pytest.raises(ValueError, match="unknown mode"):
        t_ds.constant_diffusion_dataset(1, n=4, mode="other", device=CPU)


def test_frequency_study_and_stretched_datasets_identical():
    same_dataset(j_ds.frequency_study_dataset(n=5, max_freq=1.0),
                 t_ds.frequency_study_dataset(n=5, max_freq=1.0, device=CPU))
    same_dataset(j_ds.stretched_mesh_dataset(5, n_cells=4, seed=7),
                 t_ds.stretched_mesh_dataset(5, n_cells=4, seed=7,
                                             device=CPU))


def test_parallel_generation_matches_serial(monkeypatch):
    """The spawn pool, taken once CUDA is up, gives the serial results.
    (No fork pool here: this process runs JAX's threads.)"""
    args = [((0.5 * i, 1.0, 1.5, 0.5 * i), 5, None, False) for i in range(3)]
    serial = [t_ds._gen_cosine(a) for a in args]
    assert t_ds.pool_kind(len(args)) == "serial"
    monkeypatch.setattr(t_ds.torch.cuda, "is_initialized", lambda: True)
    assert t_ds.pool_kind(len(args), min_parallel=1) == "spawn"
    pooled = t_ds._parallel_map(t_ds._gen_cosine, args, min_parallel=1)
    for a, b in zip(pooled, serial):
        np.testing.assert_array_equal(a.toarray(), b.toarray())


def test_caches_load_across_packages(tmp_path):
    j_dir, t_dir = tmp_path / "j", tmp_path / "t"
    jd = j_ds.cosine_diffusion_dataset(4, n=5, seed=1, cache_dir=str(j_dir))
    td = t_ds.cosine_diffusion_dataset(4, n=5, seed=1, cache_dir=str(t_dir),
                                       device=CPU)
    assert sorted(p.name for p in j_dir.iterdir()) == \
        sorted(p.name for p in t_dir.iterdir())
    # each package reads the other's file
    (path_j,) = j_dir.iterdir()
    (path_t,) = t_dir.iterdir()
    same_dataset(jd, t_ds._load_stacked(str(path_j), CPU))
    same_dataset(j_ds._load_stacked(str(path_t)), td)
    # and the cached path of each reads it back
    same_dataset(jd, t_ds.cosine_diffusion_dataset(
        4, n=5, seed=1, cache_dir=str(j_dir), device=CPU))


def test_data_module_and_rel_coords_identical():
    for j, t in zip(j_ds.diffusion_data_module("cosine", num_matrices=10,
                                               n=5),
                    t_ds.diffusion_data_module("cosine", num_matrices=10,
                                               n=5, device=CPU)):
        same_dataset(j, t)
        assert t.n_graphs == j.n_graphs
    with pytest.raises(ValueError, match="unknown problem_type"):
        t_ds.diffusion_data_module("nope", device=CPU)
    jd = j_ds.cosine_diffusion_dataset(2, n=6, seed=0)
    td = t_ds.cosine_diffusion_dataset(2, n=6, seed=0, device=CPU)
    np.testing.assert_array_equal(
        t_ds.periodic_rel_coords(td.template_nodiag, 6),
        j_ds.periodic_rel_coords(jd.template_nodiag, 6))


# ------------------------------------------------------------------- model
@pytest.fixture(scope="module")
def bucket():
    n = 6
    jd = j_ds.cosine_diffusion_dataset(3, n=n, seed=5)
    td = t_ds.cosine_diffusion_dataset(3, n=n, seed=5, device=CPU)
    return n, jd, td, j_train.edge_features(jd, n)


@pytest.mark.parametrize("cfg", [WIDE, dict(n_layers_external=1,
                                            n_layers_internal=1,
                                            n_hidden=8)],
                         ids=["2ext_enc_dec", "1ext_1int"])
@pytest.mark.parametrize("path", ["edge", "grid", "band", "ell"])
def test_forward_matches_jax(bucket, cfg, path):
    n, jd, td, rel = bucket
    jm = j_dg.DiffusionGNN(**cfg)
    params = jax_init(jm, jd, 0, n)
    tm = port_model(cfg, params)
    ov, d, g = jd.offdiag_vals, jd.diags, jd.globals_
    if path == "edge":
        want = jax.jit(j_train.make_apply(jm, jd, rel))(
            params, f32j(ov), f32j(d), f32j(g))
        with torch.no_grad():
            got = t_train.make_apply(tm, td, rel)(f32t(ov), f32t(d), f32t(g))
        assert_close(got, want)
        return
    if path == "grid":
        jl, jp, _ = j_band.choose_edge_layout(jd.template_nodiag, (n, n))
        tl, tp, kind = t_band.choose_edge_layout(td.template_nodiag, (n, n))
        assert kind == "grid"
    elif path == "band":
        jl = j_band.BandLayout(jd.template_nodiag)
        jp = j_band.BandPattern.from_layout(jl)
        tl = t_band.BandLayout(td.template_nodiag)
        tp = t_band.BandPattern.from_layout(tl, CPU)
    else:
        jl = j_band.EllLayout.from_operator(jd.template_nodiag)
        jp = j_band.EllPattern.from_layout(jl)
        tl = t_band.EllLayout.from_operator(td.template_nodiag)
        tp = t_band.EllPattern.from_layout(tl, CPU)
    rel_b = np.moveaxis(jl.pack(np.ascontiguousarray(rel.T)), 0, -1)
    ovb = jl.pack(ov)
    e = np.concatenate([ovb[..., None],
                        np.broadcast_to(rel_b, ovb.shape + (2,))], axis=-1)
    want = jax.jit(jax.vmap(lambda ee, dd, gg: jm.apply(params, jp, JState(
        vertices=dd[:, None], edges=ee, globals_=gg))))(f32j(e), f32j(d),
                                                        f32j(g))
    with torch.no_grad():
        got = tm(tp, GraphState(vertices=f32t(d)[..., None], edges=f32t(e),
                                globals_=f32t(g)))
        # one graph, unbatched, gives the same as its batch row
        one = tm(tp, GraphState(vertices=f32t(d[0])[:, None],
                                edges=f32t(e[0]), globals_=f32t(g[0])))
    assert_close(got, want)
    assert_close(one, np.asarray(want)[0])


def test_forward_single_graph_and_graph_batch(bucket):
    """The edge path on one graph and on a block-diagonal GraphBatch of
    two (per-graph globals), against JAX's."""
    n, jd, td, rel = bucket
    jm = j_dg.DiffusionGNN(**WIDE)
    params = jax_init(jm, jd, 2, n)
    tm = port_model(WIDE, params)
    e = np.concatenate([jd.offdiag_vals[:, :, None],
                        np.broadcast_to(rel, (3,) + rel.shape)], axis=-1)
    want = jm.apply(params, jd.template_nodiag, JState(
        vertices=f32j(jd.diags[0])[:, None], edges=f32j(e[0]),
        globals_=f32j(jd.globals_[0])))
    with torch.no_grad():
        got = tm(td.template_nodiag, GraphState(
            vertices=f32t(jd.diags[0])[:, None], edges=f32t(e[0]),
            globals_=f32t(jd.globals_[0])))
    assert_close(got, want)

    j_ops = [jd.template_nodiag.with_values(f32j(jd.offdiag_vals[i]))
             for i in range(2)]
    t_ops = [td.template_nodiag.with_values(
        jd.offdiag_vals[i].astype(np.float32)) for i in range(2)]
    j_big, j_b = j_batch_operators(j_ops)
    t_big, t_b = batch_operators(t_ops)
    v = np.concatenate([jd.diags[0], jd.diags[1]])[:, None]
    ee = np.concatenate([e[0], e[1]])
    g = jd.globals_[:2] * np.array([[1.0], [2.0]])
    want = jm.apply(params, j_big, JState(vertices=f32j(v), edges=f32j(ee),
                                          globals_=f32j(g)), j_b)
    with torch.no_grad():
        got = tm(t_big, GraphState(vertices=f32t(v), edges=f32t(ee),
                                   globals_=f32t(g)), t_b)
    assert_close(got, want)


def test_submodule_names_follow_flax(bucket):
    n, jd, _, _ = bucket
    params = jax_init(j_dg.DiffusionGNN(**WIDE), jd, 0, n)
    tm = t_dg.DiffusionGNN(**WIDE, device=CPU)
    assert set(diffusion_params_to_jax(tm)) == set(
        j_save_keys(params))
    assert isinstance(tm.gn0_edge, t_dg.MLPStack)
    assert not hasattr(t_dg.DiffusionGNN(1, 2, device=CPU), "gn0_global")


def j_save_keys(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return [jax.tree_util.keystr(kp) for kp, _ in flat]


def test_init_follows_flax_distribution(bucket):
    """Kernels: truncated lecun normal (std sqrt(1/fan_in), cut at 2
    std / 0.8796 of the underlying normal), biases 0, as flax's Dense;
    moments against JAX's own draw. The values are not meant to agree."""
    n, jd, _, _ = bucket
    cfg = dict(n_layers_external=2, n_layers_internal=2, n_hidden=48)
    params = jax_init(j_dg.DiffusionGNN(**cfg), jd, 0, n)
    jflat = {k: np.asarray(v) for k, v in zip(
        j_save_keys(params), jax.tree_util.tree_leaves(params))}
    tm = t_dg.DiffusionGNN(**cfg, generator=torch.Generator().manual_seed(0),
                           device=CPU)
    tflat = diffusion_params_to_jax(tm)
    checked = 0
    for key, w in tflat.items():
        wj = jflat[key]
        assert w.shape == wj.shape, key
        if key.endswith("['bias']"):
            assert not w.any() and not wj.any()
            continue
        std = np.sqrt(1.0 / w.shape[0])
        assert np.abs(w).max() <= 2 * std / t_dg._TRUNC_STD + 1e-6
        if w.size >= 2000:
            checked += 1
            for ww in (w, wj):
                assert abs(ww.mean()) < 4 * std / np.sqrt(ww.size)
                assert abs(ww.std() / std - 1) < 0.06, (key, ww.std(), std)
            assert abs(w.std() / wj.std() - 1) < 0.08
    assert checked >= 4
    # the seed decides the draw
    again = t_dg.DiffusionGNN(**cfg, generator=0, device=CPU)
    state = t_dg.init_diffusion_gnn(0, t_dg.DiffusionGNN(**cfg, device=CPU))
    for k, v in again.state_dict().items():
        assert torch.equal(v, state[k])


def test_artifact_at_full_width_matches_jax():
    """The committed parameters (1 external / 2 internal / 32 hidden /
    encoder (3, 16)) at n = 80 on 4 graphs of the seed-41 dataset: the
    production grid path against JAX's, and against JAX's edge path."""
    n = 80
    jd = j_ds.cosine_diffusion_dataset(4, n=n, seed=41)
    td = t_ds.cosine_diffusion_dataset(4, n=n, seed=41, device=CPU)
    same_dataset(jd, td)
    jm = j_dg.DiffusionGNN(**ARTIFACT_CFG)
    params = j_load_npz(f"{ARTIFACT}/params.npz", jax_init(jm, jd, 0, n))
    tm = load_diffusion_params_npz(f"{ARTIFACT}/params.npz",
                                   t_dg.DiffusionGNN(**ARTIFACT_CFG,
                                                     device=CPU))
    rel = j_train.edge_features(jd, n)
    j_apply, j_pack = j_train.make_apply_banded(jm, jd, rel, (n, n))
    t_apply, t_pack = t_train.make_apply_banded(tm, td, rel, (n, n))
    ov, d, g = jd.offdiag_vals, jd.diags, jd.globals_
    want = jax.jit(j_apply)(params, f32j(j_pack(ov)), f32j(d), f32j(g))
    with torch.no_grad():
        got = t_apply(f32t(t_pack(ov)), f32t(d), f32t(g))
        got_edge = t_train.make_apply(tm, td, rel)(f32t(ov[:2]), f32t(d[:2]),
                                                   f32t(g[:2]))
    assert_close(got, want)
    assert_close(got_edge, np.asarray(want)[:2])
    assert_close(t_train.loss_terms(got, f32t(jd.targets)),
                 j_train.loss_terms(want, f32j(jd.targets)))


# ------------------------------------------------------------------- loss
@pytest.mark.parametrize("case", ["ties_at_zero", "negative_ties",
                                  "random"])
def test_loss_and_gradient_match_jax_grad(case):
    rng = np.random.default_rng(11)
    pred = rng.standard_normal((2, 9, 2)).astype(np.float32)
    if case == "ties_at_zero":    # positive predictions and exact zeros
        pred = np.abs(pred)
        pred[0, :4] = 0.0
    elif case == "negative_ties":  # the penalty's max tied across entries
        pred[0, 0, 0] = pred[1, 3, 1] = pred[1, 5, 0] = -2.5
        pred[0, 2] = 0.0
    y = rng.random((2, 9, 2)).astype(np.float32)
    val_j, grad_j = jax.value_and_grad(j_train.loss_terms)(f32j(pred),
                                                           f32j(y))
    pt = f32t(pred).requires_grad_(True)
    val_t = t_train.loss_terms(pt, f32t(y))
    val_t.backward()
    assert_close(val_t.detach(), val_j, rtol=1e-4, atol_scale=0.0)
    assert_close(pt.grad, grad_j, rtol=1e-4, atol_scale=1e-6)


# --------------------------------------------------------------- training
@pytest.mark.parametrize("model_cfg", [
    WIDE, dict(n_layers_external=1, n_layers_internal=2, n_hidden=8,
               encoder=(3, 4))], ids=["2ext_enc_dec", "artifact_form"])
def test_train_histories_match_jax(capsys, model_cfg):
    """16 matrices at n = 8, 2 epochs of batch 4 at lr 1e-2, both
    packages from JAX's initial parameters: the same split, batches and
    plateau feeding."""
    n = 8
    cfg_kw = dict(num_matrices=16, n_mesh=n, epochs=2, batch_size=4,
                  lr=1e-2, seed=41, cache_dir=None, log_every=1,
                  **model_cfg)
    jd = j_ds.cosine_diffusion_dataset(16, n=n, seed=41)
    td = t_ds.cosine_diffusion_dataset(16, n=n, seed=41, device=CPU)
    jcfg = j_train.TrainDiffusionConfig(**cfg_kw)
    init = jax_init(j_dg.DiffusionGNN(**model_cfg), jd, jcfg.seed, n)
    j_best, j_hist = j_train.train(jcfg, dataset=jd)
    model, t_hist = t_train.train(
        t_train.TrainDiffusionConfig(**cfg_kw), dataset=td,
        init_params=diffusion_params_from_jax(
            jax.tree.map(np.asarray, init)), device=CPU)
    for key in ("train_loss", "val_loss"):
        assert len(t_hist[key]) == len(j_hist[key]) == 2
        assert_close(t_hist[key], j_hist[key], rtol=1e-4, atol_scale=0.0)
    assert_close(t_hist["test_loss"], j_hist["test_loss"], rtol=1e-4,
                 atol_scale=0.0)
    # the model returned holds the best parameters, as JAX's best_params
    best = diffusion_params_from_jax(jax.tree.map(np.asarray, j_best))
    for k, v in model.state_dict().items():
        assert_close(v, best[k], rtol=1e-3, atol_scale=1e-4)
    assert "test loss" in capsys.readouterr().out


def test_train_keeps_best_and_stops_early(tmp_path):
    """patience 1 at a learning rate that overshoots: training stops once
    the validation loss fails to improve, the returned model's validation
    loss is the best one, and one checkpoint is written per epoch."""
    n = 6
    td = t_ds.cosine_diffusion_dataset(20, n=n, seed=3, device=CPU)
    cfg = t_train.TrainDiffusionConfig(
        num_matrices=20, n_mesh=n, epochs=8, batch_size=4, lr=0.5, seed=3,
        patience=1, n_layers_internal=1, n_hidden=6, cache_dir=None,
        checkpoint_dir=str(tmp_path), log_every=0)
    model, hist = t_train.train(cfg, dataset=td, device=CPU)
    n_epochs = len(hist["val_loss"])
    assert n_epochs < 8 and len(list(tmp_path.iterdir())) == n_epochs
    rng = np.random.default_rng(3)
    perm = rng.permutation(20)
    va = td.select(perm[14:18])
    apply_fn, pack = t_train.make_apply_banded(
        model, td, t_train.edge_features(td, n), (n, n))
    with torch.no_grad():
        val = float(t_train.loss_terms(apply_fn(
            f32t(pack(va.offdiag_vals)), f32t(va.diags), f32t(va.globals_)),
            f32t(va.targets)))
    assert val == pytest.approx(min(hist["val_loss"]), rel=1e-6)


def test_train_refuses_data_parallel():
    """Data-parallel training needs a "data" mesh or a process group of
    n_devices ranks (tests/test_torch_parallel_train.py runs it)."""
    cfg = t_train.TrainDiffusionConfig(num_matrices=4, n_mesh=4,
                                       cache_dir=None)
    with pytest.raises(TypeError, match="'data' axis"):
        t_train.train(cfg, mesh=object(), device=CPU)
    cfg.n_devices = 2
    with pytest.raises(RuntimeError, match="initialized process group"):
        t_train.train(cfg, device=CPU)


# ---------------------------------------------------------- parameter files
def test_params_round_trip_through_jax_loader(tmp_path, bucket):
    """A model the port holds, written with `save_diffusion_params_npz`,
    loads with the JAX package's `load_params_npz` and gives JAX's forward
    the port's outputs; the committed artifact loads into the port."""
    n, jd, td, rel = bucket
    jm = j_dg.DiffusionGNN(**WIDE)
    template = jax_init(jm, jd, 0, n)
    tm = t_dg.DiffusionGNN(**WIDE, generator=9, device=CPU)
    path = str(tmp_path / "port.npz")
    save_diffusion_params_npz(path, tm)
    params = j_load_npz(path, template)
    want = jax.jit(j_train.make_apply(jm, jd, rel))(
        params, f32j(jd.offdiag_vals), f32j(jd.diags), f32j(jd.globals_))
    with torch.no_grad():
        got = t_train.make_apply(tm, td, rel)(
            f32t(jd.offdiag_vals), f32t(jd.diags), f32t(jd.globals_))
    assert_close(got, want)
    # and back: JAX's writer, the port's reader
    j_path = str(tmp_path / "jax.npz")
    j_save_npz(j_path, params)
    back = diffusion_params_from_jax(j_path)
    for k, v in tm.state_dict().items():
        assert torch.equal(back[k], v)
    art = t_dg.DiffusionGNN(**ARTIFACT_CFG, device=CPU)
    load_diffusion_params_npz(f"{ARTIFACT}/params.npz", art)
    with np.load(f"{ARTIFACT}/params.npz") as z:
        np.testing.assert_array_equal(
            art.gn0_edge.layers[0].weight.detach().numpy(),
            z["['params']['gn0_edge']['Dense_0']['kernel']"].T)
    with pytest.raises(ValueError, match="flax Dense"):
        diffusion_params_from_jax({"['params']['x']['kernel']": np.zeros(1)})
