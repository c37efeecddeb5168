"""The port's public names and printed lines against the JAX package's,
on the CPU: the `ops` and `amg` re-exports, `segment_normalize`,
`save_params_npz` read back by the JAX `load_params_npz`,
`CheckpointManager` driven alongside the orbax manager, and the lines the
trainers print at log_every=0."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnnla_tpu.amg as j_amg
import gnnla_tpu.ops as j_ops
import gnnla_tpu_torch.amg as t_amg
import gnnla_tpu_torch.ops as t_ops
from gnnla_tpu.ops.segment import segment_normalize as j_segment_normalize
from gnnla_tpu.training import checkpoints as j_ckpt
from gnnla_tpu.training import datasets as j_ds
from gnnla_tpu_torch.ops.segment import segment_normalize
from gnnla_tpu_torch.training import checkpoints as t_ckpt
from gnnla_tpu_torch.training import datasets as t_ds

j_tj = importlib.import_module("gnnla_tpu.models.trainable_jacobi")
t_tj = importlib.import_module("gnnla_tpu_torch.models.trainable_jacobi")
j_jac = importlib.import_module("gnnla_tpu.training.train_jacobi")
t_jac = importlib.import_module("gnnla_tpu_torch.training.train_jacobi")
j_dif = importlib.import_module("gnnla_tpu.training.train_diffusion")
t_dif = importlib.import_module("gnnla_tpu_torch.training.train_diffusion")
j_dg = importlib.import_module("gnnla_tpu.models.diffusion_gnn")

CPU = "cpu"


@pytest.mark.parametrize("pkg", ["ops", "amg"])
def test_package_reexports_the_jax_names(pkg):
    """Every name of the JAX package's __all__ is in the port's __all__
    and an attribute of the port's package."""
    jpkg, tpkg = {"ops": (j_ops, t_ops), "amg": (j_amg, t_amg)}[pkg]
    for name in jpkg.__all__:
        assert name in tpkg.__all__ and hasattr(tpkg, name), name
    assert len(tpkg.__all__) == len(jpkg.__all__)


def test_reexports_are_the_submodules_objects():
    from gnnla_tpu_torch.amg import split
    from gnnla_tpu_torch.amg.splitting import split as split_mod
    from gnnla_tpu_torch.ops import SparseOperator
    from gnnla_tpu_torch.ops.sparse import SparseOperator as sparse_mod
    assert split is split_mod and SparseOperator is sparse_mod
    with pytest.raises(AttributeError):
        t_ops.no_such_name  # noqa: B018


@pytest.mark.parametrize("feat", [1, 3])
def test_segment_normalize_matches_jax(feat):
    """Each element over its segment's L2 norm; rtol 1e-6 (one sqrt and
    one division in f32 on both sides, sums in other orders)."""
    gen = np.random.default_rng(1)
    shape = (200,) if feat == 1 else (200, feat)
    data = gen.standard_normal(shape).astype(np.float32)
    ids = np.sort(gen.integers(0, 30, 200)).astype(np.int32)
    want = np.asarray(j_segment_normalize(jnp.asarray(data),
                                          jnp.asarray(ids), 30))
    got = segment_normalize(torch.from_numpy(data), torch.from_numpy(ids),
                            30).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_save_params_npz_is_read_by_jax(tmp_path):
    """The Jacobi MLP written by the port, read by the JAX package's
    load_params_npz on the JAX model's own template: every leaf equal
    (kernels transposed), and carried back into the port bit for bit."""
    model = t_tj.TrainableJacobiMLP(device=CPU)
    path = str(tmp_path / "params.npz")
    t_ckpt.save_params_npz(path, model)
    template = j_tj.init_params(jax.random.PRNGKey(0))
    loaded = j_ckpt.load_params_npz(path, template)
    state = model.state_dict()
    for i, layer in enumerate(sorted(loaded["params"])):
        assert layer == f"Dense_{i}"
        np.testing.assert_array_equal(
            loaded["params"][layer]["kernel"],
            state[f"layers.{i}.weight"].numpy().T)
        np.testing.assert_array_equal(loaded["params"][layer]["bias"],
                                      state[f"layers.{i}.bias"].numpy())
    back = t_tj.TrainableJacobiMLP(device=CPU)
    t_ckpt.load_params_npz(path, back)
    for k, v in back.state_dict().items():
        assert torch.equal(v, state[k]), k
    # the committed artifact's format, key for key
    with np.load("artifacts/jacobi/params.npz") as art, np.load(path) as z:
        assert sorted(art.files) == sorted(z.files)
        for k in art.files:
            assert art[k].shape == z[k].shape and z[k].dtype == np.float32


def test_save_params_npz_writes_a_diffusion_model(tmp_path):
    from gnnla_tpu_torch.models.diffusion_gnn import DiffusionGNN
    model = DiffusionGNN(n_layers_external=1, n_layers_internal=1,
                         n_hidden=4, device=CPU)
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    t_ckpt.save_params_npz(a, model)
    t_ckpt.save_diffusion_params_npz(b, model)
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k])


@pytest.mark.parametrize("max_to_keep", [None, 2, 3])
def test_checkpoint_manager_matches_orbax(tmp_path, max_to_keep):
    """Both managers through one sequence of steps and val_loss metrics
    (ties, one step without the metric): the kept steps, best_step,
    latest_step and the restored latest and best values agree."""
    losses = [0.5, 0.3, 0.4, 0.3, None, 0.2, 0.6]
    jm = j_ckpt.CheckpointManager(str(tmp_path / "jax"),
                                  max_to_keep=max_to_keep)
    tm = t_ckpt.CheckpointManager(str(tmp_path / "torch"),
                                  max_to_keep=max_to_keep)
    gen = np.random.default_rng(3)
    values = {}
    for step, loss in enumerate(losses):
        w = gen.standard_normal(5).astype(np.float32)
        values[step] = w
        metrics = {} if loss is None else {"val_loss": loss}
        jm.save(step, {"w": w}, metrics=metrics)
        tm.save(step, {"w": torch.from_numpy(w)}, metrics=metrics)
        assert tm.all_steps() == sorted(jm._mgr.all_steps()), step
        assert tm.best_step() == jm.best_step(), step
        assert tm.latest_step() == jm.latest_step(), step
    for step in (tm.latest_step(), tm.best_step()):
        got = tm.restore(step)["w"].numpy()
        want = np.asarray(jm.restore(step)["w"])
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, values[step])
    np.testing.assert_array_equal(tm.restore()["w"].numpy(),
                                  values[tm.latest_step()])
    jm.close()
    tm.close()
    # a manager opened on the directory takes up its steps
    again = t_ckpt.CheckpointManager(str(tmp_path / "torch"),
                                     max_to_keep=max_to_keep)
    assert again.all_steps() == tm.all_steps()
    assert again.best_step() == tm.best_step()


def test_checkpoint_manager_restores_into_a_module(tmp_path):
    model = t_tj.TrainableJacobiMLP(generator=0, device=CPU)
    tm = t_ckpt.CheckpointManager(str(tmp_path))
    assert tm.restore() is None and tm.best_step() is None
    tm.save(0, model, metrics={"val_loss": 1.0})
    fresh = t_tj.TrainableJacobiMLP(generator=1, device=CPU)
    assert tm.restore(template=fresh) is fresh
    state = model.state_dict()
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, state[k])


JACOBI = dict(num_matrices=16, n_mesh=10, epochs=2, batch_size=8,
              n_train=12, n_val=2, n_test=2, m_probes=8, cache_dir=None,
              log_every=0)


def _lines(out: str):
    return [ln for ln in out.splitlines() if ln.strip()]


def assert_same_lines(j_out, t_out, rtol):
    """The same lines: equal text, and each line's number (its last word)
    within rtol, since a loss that agrees to rtol can round to another
    last printed digit."""
    assert len(j_out) == len(t_out), (j_out, t_out)
    for a, b in zip(j_out, t_out):
        (ta, na), (tb, nb) = a.rsplit(" ", 1), b.rsplit(" ", 1)
        assert ta == tb, (a, b)
        assert float(nb) == pytest.approx(float(na), rel=rtol), (a, b)


def test_jacobi_trainer_prints_the_jax_lines(capsys, tmp_path):
    """At log_every=0 both trainers print only the test loss, the same
    line; with checkpoint_dir both save one step an epoch."""
    pj = j_tj.init_params(jax.random.PRNGKey(0))
    j_jac.train(j_jac.TrainJacobiConfig(
        **JACOBI, checkpoint_dir=str(tmp_path / "jax")), init_params=pj)
    j_out = _lines(capsys.readouterr().out)
    _, hist = t_jac.train(
        t_jac.TrainJacobiConfig(**JACOBI,
                                checkpoint_dir=str(tmp_path / "torch")),
        init_params=t_ckpt.params_from_jax(pj), device=CPU)
    t_out = _lines(capsys.readouterr().out)
    assert t_out == [f"test loss: {hist['test_loss']:.5f}"]
    # test_torch_training.py's history tolerance
    assert_same_lines(j_out, t_out, rtol=1e-3)
    tm = t_ckpt.CheckpointManager(str(tmp_path / "torch"))
    jm = j_ckpt.CheckpointManager(str(tmp_path / "jax"))
    assert tm.all_steps() == sorted(jm._mgr.all_steps()) == [0, 1]
    assert tm.best_step() == jm.best_step()
    fresh = t_tj.TrainableJacobiMLP(device=CPU)
    assert t_ckpt.load_checkpoint(str(tmp_path / "torch" / "epoch_0001.pt"),
                                  fresh) == {
        "val_loss": hist["val_loss"][1]}
    jm.close()


def test_diffusion_trainer_prints_the_jax_lines(capsys, tmp_path):
    """At log_every=0 with patience 1 both print the early stop and the
    test loss, the same lines (the loss within rtol 1e-4); both managers
    keep the same steps and best step."""
    n = 8
    model_cfg = dict(n_layers_external=1, n_layers_internal=2, n_hidden=8,
                     encoder=(3, 4))
    cfg_kw = dict(num_matrices=16, n_mesh=n, epochs=6, batch_size=4,
                  lr=5e-2, seed=41, patience=1, cache_dir=None, log_every=0,
                  **model_cfg)
    jd = j_ds.cosine_diffusion_dataset(16, n=n, seed=41)
    td = t_ds.cosine_diffusion_dataset(16, n=n, seed=41, device=CPU)
    jcfg = j_dif.TrainDiffusionConfig(
        **cfg_kw, checkpoint_dir=str(tmp_path / "jax"))
    rel = j_dif.edge_features(jd, n)
    e0 = jnp.concatenate([jnp.asarray(jd.offdiag_vals[0], jnp.float32)[
        :, None], jnp.asarray(rel, jnp.float32)], axis=1)
    from gnnla_tpu.core import GraphState as JState
    s0 = JState(vertices=jnp.asarray(jd.diags[0], jnp.float32)[:, None],
                edges=e0, globals_=jnp.asarray(jd.globals_[0], jnp.float32))
    init = j_dg.DiffusionGNN(**model_cfg).init(
        jax.random.PRNGKey(jcfg.seed), jd.template_nodiag, s0)
    _, j_hist = j_dif.train(jcfg, dataset=jd)
    j_out = _lines(capsys.readouterr().out)
    _, t_hist = t_dif.train(
        t_dif.TrainDiffusionConfig(**cfg_kw,
                                   checkpoint_dir=str(tmp_path / "torch")),
        dataset=td, init_params=t_ckpt.diffusion_params_from_jax(
            jax.tree.map(np.asarray, init)), device=CPU)
    t_out = _lines(capsys.readouterr().out)
    assert len(t_hist["val_loss"]) == len(j_hist["val_loss"]) < 6
    # test_torch_diffusion.py's history tolerance
    assert_same_lines(j_out, t_out, rtol=1e-4)
    assert t_out[0] == f"early stopping at epoch {len(t_hist['val_loss'])}"
    assert t_out[1] == f"test loss: {t_hist['test_loss']:.5f}"
    tm = t_ckpt.CheckpointManager(str(tmp_path / "torch"))
    jm = j_ckpt.CheckpointManager(str(tmp_path / "jax"))
    assert tm.all_steps() == sorted(jm._mgr.all_steps())
    assert tm.best_step() == jm.best_step()
    jm.close()
