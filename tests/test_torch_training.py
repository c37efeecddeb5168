"""The port's training path of the learned Jacobi smoother against the JAX
package on the CPU: problems, datasets, segment and band reductions,
features, the MLP and its parameters carried across, the spectral losses
and their gradients, the plateau scale, and whole training runs.

The same inputs, made from numpy seeds, go through both packages; flax
parameter trees are carried across with `params_from_jax`.

Tolerances: host numpy (matrices, datasets, probes) equal exactly;
reductions and features rtol 1e-6 (atol 1e-6 * max where random data
cancel); MLP outputs rtol 1e-5; losses rtol 1e-5 and their
gradients rtol 1e-4 (atol 1e-6 * max|g|): f32 sums in another order.
Training histories rtol 1e-3: those differences compound through Adam.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnla_tpu.core import block as j_block
from gnnla_tpu.models import trainable_jacobi as j_tj
from gnnla_tpu.ops import band as j_band
from gnnla_tpu.ops import segment as j_seg
from gnnla_tpu.ops.pallas_stencil import stencil_matvec_jnp
from gnnla_tpu.ops.pallas_stencil import stencil_transpose as j_stencil_t
from gnnla_tpu.ops.sparse import SparseOperator as JSparse
from gnnla_tpu.problems import laplacian_2d as j_laplacian_2d
from gnnla_tpu.problems import small_band as j_small_band
from gnnla_tpu.training import spectral_loss as j_sl
from gnnla_tpu.training.checkpoints import load_params_npz as j_load_npz
from gnnla_tpu.training.checkpoints import save_params_npz as j_save_npz
from gnnla_tpu.training.datasets import small_band_dataset as j_dataset
from gnnla_tpu_torch.core.block import EdgeAggregator, make_edge_aggregator
from gnnla_tpu_torch.models import trainable_jacobi as t_tj
from gnnla_tpu_torch.ops import band as t_band
from gnnla_tpu_torch.ops import segment as t_seg
from gnnla_tpu_torch.ops.dia import dia_matvec
from gnnla_tpu_torch.ops.sparse import SparseOperator as TSparse
from gnnla_tpu_torch.ops.stencil import stencil_matvec, stencil_transpose
from gnnla_tpu_torch.problems import laplacian_2d
from gnnla_tpu_torch.problems import small_band as t_small_band
from gnnla_tpu_torch.training import spectral_loss as t_sl
from gnnla_tpu_torch.training.checkpoints import (load_checkpoint,
                                                  load_params_npz,
                                                  params_from_jax,
                                                  save_checkpoint)
from gnnla_tpu_torch.training.datasets import small_band_dataset

# the packages export the function `train_jacobi`; the tests need the
# modules of the same name
j_train = importlib.import_module("gnnla_tpu.training.train_jacobi")
t_train = importlib.import_module("gnnla_tpu_torch.training.train_jacobi")

CPU = "cpu"
OMEGA = 2.0 / 3.0
ARTIFACT = "artifacts/jacobi"


def assert_close(got, want, rtol, atol_scale=0.0):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * np.abs(want).max())


def f32(a, requires_grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32,
                        requires_grad=requires_grad)


def jparams(seed=0, scheme="reference"):
    return j_tj.init_params(jax.random.PRNGKey(seed), init_scheme=scheme)


def port_mlp(params_j, scheme="reference"):
    model = t_tj.TrainableJacobiMLP(init_scheme=scheme, device=CPU)
    model.load_state_dict(params_from_jax(params_j))
    return model


def carry(op_j):
    rows, cols, vals = op_j.host_coo()
    return TSparse.from_coo(rows, cols, vals, op_j.shape, coalesce=False,
                            device=CPU)


@pytest.fixture(scope="module")
def datasets():
    """The same 6-matrix n = 10 bucket from both packages."""
    return (j_dataset(6, n=10, seed=7),
            small_band_dataset(6, n=10, seed=7, device=CPU))


# ------------------------------------------------------ problems, data
@pytest.mark.parametrize("n,h,loc", [(10, 0.01, 0.5), (12, 0.003, 0.21),
                                     (38, 0.0005, 0.93)])
def test_small_band_matrix_identical(n, h, loc):
    Kj, xyj, blj = j_small_band.small_band_matrix_host(n, h, loc)
    Kt, xyt, blt = t_small_band.small_band_matrix_host(n, h, loc)
    assert blj == blt
    np.testing.assert_array_equal(xyj, xyt)
    for a in ("row", "col", "data"):
        np.testing.assert_array_equal(getattr(Kj, a), getattr(Kt, a))
    op, _, _ = t_small_band.small_band_matrix(n, h, loc, device=CPU)
    assert op.device.type == "cpu" and op.nnz == Kj.nnz


def test_small_band_dataset_identical_and_caches_share_a_format(tmp_path):
    dj = j_dataset(8, n=10, seed=1, cache_dir=str(tmp_path / "j"))
    dt = small_band_dataset(8, n=10, seed=1, cache_dir=str(tmp_path / "t"),
                            device=CPU)
    for a in ("vals", "offdiag_vals", "diags", "coords"):
        np.testing.assert_array_equal(getattr(dj, a), getattr(dt, a))
    for k in ("h", "band_loc"):
        np.testing.assert_array_equal(dj.meta[k], dt.meta[k])
    for a, b in zip(dj.template.host_coo(), dt.template.host_coo()):
        np.testing.assert_array_equal(a, b)
    assert dt.template_nodiag.nnz == dj.template_nodiag.nnz
    # each package reads the other's cache file
    dj2 = j_dataset(8, n=10, seed=1, cache_dir=str(tmp_path / "t"))
    dt2 = small_band_dataset(8, n=10, seed=1, cache_dir=str(tmp_path / "j"),
                             device=CPU)
    np.testing.assert_array_equal(dj2.vals, dt.vals)
    np.testing.assert_array_equal(dt2.coords, dj.coords)
    np.testing.assert_array_equal(dt.dia_stack()[1], dj.dia_stack()[1])
    assert dt.dia_stack()[0] == dj.dia_stack()[0]
    sel = dt.select([3, 1])
    np.testing.assert_array_equal(sel.diags, dj.select([3, 1]).diags)


# ------------------------------------------- segment, aggregators, band
def _edges(rng, n=9, e=30, sort=True):
    rows = rng.integers(0, n - 2, e)  # rows n-2, n-1 stay empty
    if sort:
        rows = np.sort(rows)
    return rows, rng.standard_normal((e, 3)).astype(np.float32)


@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
def test_segment_reductions_match_jax(reduce):
    rows, data = _edges(np.random.default_rng(1))
    want = j_seg.segment_reduce(reduce, jnp.asarray(data),
                                jnp.asarray(rows), 9)
    got = t_seg.segment_reduce(reduce, f32(data), torch.from_numpy(rows), 9)
    assert_close(got, want, rtol=1e-6, atol_scale=1e-6)
    assert not got[-2:].any()  # empty segments: the JAX fill, 0
    got1 = t_seg.multi_segment_reduce(("min", "mean", "sum", "max"),
                                      f32(data[:, 0]), torch.from_numpy(rows),
                                      9)
    want1 = j_seg.multi_segment_reduce(("min", "mean", "sum", "max"),
                                       jnp.asarray(data[:, 0]),
                                       jnp.asarray(rows), 9)
    assert_close(got1, want1, rtol=1e-6, atol_scale=1e-6)


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
def test_dense_row_layout_and_edge_aggregator_match_jax(sort):
    rng = np.random.default_rng(2)
    rows, data = _edges(rng, sort=sort)
    mask = rng.random(rows.size) > 0.3
    red = ("min", "mean", "sum", "max")
    jl, tl = j_seg.DenseRowLayout(rows, 9), t_seg.DenseRowLayout(rows, 9)
    assert (tl.k, tl.is_reshape) == (jl.k, jl.is_reshape)
    assert_close(tl.multi(red, f32(data)), jl.multi(red, jnp.asarray(data)),
                 rtol=1e-6, atol_scale=1e-6)
    assert_close(tl.max(f32(data[:, 1])), jl.max(jnp.asarray(data[:, 1])),
                 rtol=1e-6, atol_scale=1e-6)
    ja = j_block.EdgeAggregator(jnp.asarray(rows), 9, jnp.asarray(mask))
    ta = EdgeAggregator(torch.from_numpy(rows), 9, torch.from_numpy(mask))
    assert_close(ta.multi(red, f32(data)), ja.multi(red, jnp.asarray(data)),
                 rtol=1e-6, atol_scale=1e-6)
    # a uniform row-contiguous pattern takes the reshape path
    rr = np.repeat(np.arange(5), 3)
    assert t_seg.DenseRowLayout(rr, 5).is_reshape
    assert_close(t_seg.DenseRowLayout(rr, 5).multi(red, f32(data[:15])),
                 j_seg.DenseRowLayout(rr, 5).multi(red,
                                                   jnp.asarray(data[:15])),
                 rtol=1e-6, atol_scale=1e-6)


def test_band_layout_matches_jax(datasets):
    dj, dt = datasets
    jl = j_band.BandLayout(dj.template_nodiag)
    tl = t_band.BandLayout(dt.template_nodiag)
    assert tl.offsets == jl.offsets
    np.testing.assert_array_equal(tl.mask, jl.mask)
    np.testing.assert_array_equal(tl.deg, jl.deg)
    packed = tl.pack(dt.offdiag_vals)
    np.testing.assert_array_equal(packed, jl.pack(dj.offdiag_vals))
    np.testing.assert_array_equal(tl.unpack(packed), dt.offdiag_vals)
    deg = np.maximum(jl.deg, 1).astype(np.float32)
    red = ("min", "mean", "sum", "max")
    for bands in (packed[0], np.moveaxis(packed[:3], 0, -1)):  # [K,N], [K,N,F]
        want = j_band.band_multi_reduce(red, jnp.asarray(bands, jnp.float32),
                                        jnp.asarray(jl.mask),
                                        jnp.asarray(deg))
        got = t_band.band_multi_reduce(red, f32(bands),
                                       torch.from_numpy(tl.mask), f32(deg))
        assert_close(got, want, rtol=1e-6)
    x = np.random.default_rng(0).standard_normal((7, 2)).astype(np.float32)
    for off in (-8, -3, 0, 2, 7):
        assert_close(t_band.band_shift(f32(x), off),
                     j_band.band_shift(jnp.asarray(x), off), rtol=0)


# ------------------------------------------------------------ features
def test_features_match_jax_including_explicit_zeros():
    """The kron-built Laplacian stores explicit zero edges: corner vertex 0
    has 5 stored off-diagonal entries {1, 0, 1, 0, 0} (the JAX package's
    test_jacobi_features); eliminated, 2 neighbours of +1."""
    Aj = j_laplacian_2d(3)
    At = laplacian_2d(3, device=CPU)
    for tight in (False, True):
        ndj, ndt = Aj.remove_diagonal(), At.remove_diagonal()
        if tight:
            ndj, ndt = ndj.eliminate_zeros(), ndt.eliminate_zeros()
        want = j_tj.jacobi_diag_features(ndj, Aj.diagonal())
        got = t_tj.jacobi_diag_features(ndt, At.diagonal())
        assert_close(got, want, rtol=1e-6)
        assert_close(got[0], [-4, 1, 1, 2, 1] if tight
                     else [-4, 0, 0.4, 2, 1], rtol=1e-6)


def test_features_edge_and_band_paths_match_jax(datasets):
    dj, dt = datasets
    lay, band_ov = dt.band_stack_nodiag()
    mask = torch.from_numpy(lay.mask)
    deg = f32(np.maximum(lay.deg, 1))
    batched = t_tj.jacobi_diag_features_banded(f32(dt.diags), f32(band_ov),
                                               mask, deg)
    for i in range(dt.n_graphs):
        want = j_tj.jacobi_diag_features(
            dj.template_nodiag.with_values(
                jnp.asarray(dj.offdiag_vals[i], jnp.float32)),
            jnp.asarray(dj.diags[i], jnp.float32))
        edge = t_tj.jacobi_diag_features(
            dt.template_nodiag.with_values(
                dt.offdiag_vals[i].astype(np.float32)), f32(dt.diags[i]))
        band = t_tj.jacobi_diag_features_banded(f32(dt.diags[i]),
                                                f32(band_ov[i]), mask, deg)
        for got in (edge, band, batched[i]):
            assert_close(got, want, rtol=1e-6, atol_scale=1e-7)
    op = dt.template_nodiag
    assert make_edge_aggregator(op, op.n_rows) is op.row_layout()
    assert isinstance(make_edge_aggregator(op, op.n_rows + 1),
                      EdgeAggregator)


# ------------------------------------------------------------- the MLP
@pytest.mark.parametrize("scheme", ["reference", "lecun"])
def test_mlp_from_jax_params_matches(scheme, datasets):
    _, dt = datasets
    pj = jparams(3, scheme)
    model = port_mlp(pj, scheme)
    x = np.random.default_rng(4).standard_normal((40, 5)).astype(np.float32)
    x[:, 0] += 3.0
    want = j_tj.TrainableJacobiMLP(init_scheme=scheme).apply(
        pj, jnp.asarray(x))
    assert_close(model(f32(x)).detach(), want, rtol=1e-5, atol_scale=1e-7)
    nd = dt.template_nodiag.with_values(dt.offdiag_vals[0])
    got = t_tj.predict_diag(params_from_jax(pj), nd, f32(dt.diags[0]),
                            init_scheme=scheme)
    want = j_tj.predict_diag(pj, JSparse.from_coo(
        *nd.host_coo(), nd.shape, coalesce=False),
        jnp.asarray(dt.diags[0], jnp.float32), init_scheme=scheme)
    assert_close(got.detach(), want, rtol=1e-5, atol_scale=1e-7)


def test_mlp_init_follows_the_reference():
    """5 -> 50 -> 20 -> 1, 1341 parameters; the reference init (weights
    U[0, 1), biases 0.01) drawn from a seeded torch.Generator; lecun is
    truncated at two standard deviations."""
    a = t_tj.init_params(54681)
    b = t_tj.init_params(torch.Generator().manual_seed(54681))
    assert sum(v.numel() for v in a.values()) == 1341
    for k in a:
        assert torch.equal(a[k], b[k])
    w = a["layers.0.weight"]
    assert w.shape == (50, 5) and float(w.min()) >= 0 and float(w.max()) < 1
    assert torch.all(a["layers.0.bias"] == 0.01)
    lec = t_tj.init_params(1, init_scheme="lecun")
    std = (1 / 5) ** 0.5 / 0.87962566103423978
    assert float(lec["layers.0.weight"].abs().max()) <= 2 * std
    assert not lec["layers.0.bias"].any()
    with pytest.raises(ValueError, match="init_scheme"):
        t_tj.TrainableJacobiMLP(init_scheme="xavier", device=CPU)


def test_committed_params_on_regenerated_test_matrices():
    """artifacts/jacobi/params.npz carried across: three of the 150 test
    matrices regenerated from test_eigenvalues.npz (h, snapped band
    location, n_mesh 38) give the artifact's diag_A, and the port's learned
    D^-1 equals the JAX package's on the CPU; both stay within the chip
    check's bound (3e-2) of the artifact, computed on a TPU."""
    z = np.load(f"{ARTIFACT}/test_eigenvalues.npz")
    model = t_tj.TrainableJacobiMLP(device=CPU)
    load_params_npz(f"{ARTIFACT}/params.npz", model)
    pj = j_load_npz(f"{ARTIFACT}/params.npz", jparams())
    for i in (0, 71, 149):
        K, _, _ = t_small_band.small_band_matrix_host(38, z["hs"][i],
                                                      z["band_locs"][i])
        op = TSparse.from_scipy(K, device=CPU)
        d = op.host_diagonal()
        np.testing.assert_allclose(d, z["diag_A"][i], rtol=1e-6)
        got = t_tj.predict_diag(model, op.remove_diagonal(), f32(d))
        opj = JSparse.from_scipy(K)
        want = j_tj.predict_diag(pj, opj.remove_diagonal(),
                                 jnp.asarray(d, jnp.float32))
        assert_close(got.detach(), want, rtol=1e-5)
        dinv = OMEGA / got.detach().double().numpy()
        rel = np.abs(dinv - z["diag_learn_Dinv"][i]) / np.abs(
            z["diag_learn_Dinv"][i])
        assert rel.max() < 3e-2


def test_params_files_round_trip(tmp_path):
    """The port reads the JAX package's npz files; torch.save checkpoints
    keep the state dict and metrics."""
    model = port_mlp(jparams(5))
    j_save_npz(str(tmp_path / "j.npz"), jparams(6))
    other = t_tj.TrainableJacobiMLP(device=CPU)
    load_params_npz(str(tmp_path / "j.npz"), other)
    for k, v in params_from_jax(jparams(6)).items():
        assert torch.equal(other.state_dict()[k], v)
    save_checkpoint(str(tmp_path / "c.pt"), model, {"val_loss": 0.5})
    fresh = t_tj.TrainableJacobiMLP(device=CPU)
    assert load_checkpoint(str(tmp_path / "c.pt"), fresh) == {
        "val_loss": 0.5}
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v)
    with pytest.raises(ValueError, match="Dense"):
        params_from_jax({"w": np.zeros(2)})


# ------------------------------------------------------- spectral loss
def test_probes_identical():
    for xy in (None, np.random.default_rng(0).random((36, 2))):
        a = j_sl.high_freq_probes(36, 7, xy, np.random.default_rng(3))
        b = t_sl.high_freq_probes(36, 7, xy, np.random.default_rng(3))
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        j_sl.uniform_probes(30, 4, np.random.default_rng(1)),
        t_sl.uniform_probes(30, 4, np.random.default_rng(1)))


def test_coo_gelfand_and_exact_paths_match_jax(datasets):
    dj, dt = datasets
    opj = dj.template.with_values(jnp.asarray(dj.vals[0], jnp.float32))
    opt = dt.template.with_values(dt.vals[0].astype(np.float32))
    n = opt.n_rows
    rng = np.random.default_rng(0)
    probes = j_sl.high_freq_probes(n, 6, dj.coords[0], rng).astype(
        np.float32)
    d0 = dj.diags[0].astype(np.float32)
    jl, jg = jax.value_and_grad(
        lambda d: j_sl.damping_factor_gelfand(opj, d, OMEGA,
                                              jnp.asarray(probes)))(
        jnp.asarray(d0))
    d = f32(d0, requires_grad=True)
    loss = t_sl.damping_factor_gelfand(opt, d, OMEGA, f32(probes))
    loss.backward()
    assert_close(loss.detach(), jl, rtol=1e-5)
    assert_close(d.grad, jg, rtol=1e-4, atol_scale=1e-6)
    y = rng.random((n, 3)).astype(np.float32)
    assert_close(t_sl.error_apply(opt, f32(d0), 0.7, f32(y)),
                 j_sl.error_apply(opj, jnp.asarray(d0), 0.7, jnp.asarray(y)),
                 rtol=1e-5, atol_scale=1e-6)
    assert_close(t_sl.dinv_a_spectrum(opt, d0),
                 j_sl.dinv_a_spectrum(opj, d0), rtol=1e-8, atol_scale=1e-10)
    np.testing.assert_allclose(t_sl.damping_factor_exact(opt, d0, OMEGA),
                               j_sl.damping_factor_exact(opj, d0, OMEGA),
                               rtol=1e-10)
    np.testing.assert_allclose(t_sl.optimal_omega(opt),
                               j_sl.optimal_omega(opj), rtol=1e-6)
    # the batch loss over stacked values
    pb = np.stack([probes, probes[::-1].copy()])
    want = j_sl.loss_batch_stacked(
        jnp.asarray(dj.vals[:2], jnp.float32), dj.template,
        jnp.asarray(dj.diags[:2], jnp.float32), jnp.asarray(pb))
    got = t_sl.loss_batch_stacked(f32(dt.vals[:2]), dt.template,
                                  f32(dt.diags[:2]), f32(pb))
    assert_close(got, want, rtol=1e-5)


@pytest.mark.parametrize("layout", ["dia", "stencil"])
def test_loss_fn_and_its_gradient_match_jax(layout, datasets):
    """`make_loss_fn` (banded features -> MLP -> batched Gelfand on the
    DIA or stencil layout) and its gradient in every parameter against
    the JAX package's, with and without the stability penalty."""
    dj, dt = datasets
    pj = jparams(1)
    probes = j_train._draw_probes(dj, range(dj.n_graphs), 5,
                                  np.random.default_rng(0))
    pf = np.random.default_rng(1).standard_normal(probes.shape)
    jmodel = j_tj.TrainableJacobiMLP()
    mats = j_train.matrix_stack(dj, layout)
    np.testing.assert_array_equal(t_train.matrix_stack(dt, layout), mats)
    for weight in (0.0, 2.0):
        kw = dict(layout=layout, stability_weight=weight, stability_k=4)
        jfn = j_train.make_loss_fn(jmodel, dj, OMEGA, 3, **kw)
        args = [jnp.asarray(a, jnp.float32) for a in (
            mats, j_train.feature_stack(dj), dj.diags, probes, pf)]
        jl, jg = jax.value_and_grad(jfn)(pj, *args)
        model = port_mlp(pj)
        tfn = t_train.make_loss_fn(model, dt, OMEGA, 3, **kw)
        loss = tfn(*(f32(np.asarray(a)) for a in args))
        loss.backward()
        assert_close(loss.detach(), jl, rtol=1e-5)
        for i, lin in enumerate(model.layers):
            g = jg["params"][f"Dense_{i}"]
            assert_close(lin.weight.grad.T, g["kernel"], rtol=1e-4,
                         atol_scale=1e-6)
            assert_close(lin.bias.grad, g["bias"], rtol=1e-4,
                         atol_scale=1e-6)


def test_stencil_matvec_and_transpose_match_jax():
    rng = np.random.default_rng(8)
    h, w = 6, 5
    shifts = [(0, 0), (1, 0), (h - 1, 0), (0, 1), (0, w - 2)]
    planes = rng.standard_normal((5, h, w)).astype(np.float32)
    for shape in ((h, w), (h, w, 3)):
        x = rng.standard_normal(shape).astype(np.float32)
        want = stencil_matvec_jnp(jnp.asarray(planes), shifts, jnp.asarray(x))
        assert_close(stencil_matvec(f32(planes), shifts, f32(x)), want,
                     rtol=1e-6)
    xb = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    pb = np.stack([planes, -planes])
    got = stencil_matvec(f32(pb), shifts, f32(xb))
    for b in range(2):
        assert_close(got[b], stencil_matvec_jnp(jnp.asarray(pb[b]), shifts,
                                                jnp.asarray(xb[b])),
                     rtol=1e-6)
    st_j, pt_j = j_stencil_t(shifts, jnp.asarray(planes))
    st_t, pt_t = stencil_transpose(shifts, f32(planes))
    assert st_t == st_j
    assert_close(pt_t, pt_j, rtol=0)


def test_batched_dia_matvec_matches_per_matrix(datasets):
    _, dt = datasets
    offsets, diags = dt.dia_stack()
    diags = f32(diags[:3])
    x = f32(np.random.default_rng(2).standard_normal((3, diags.shape[-1], 4)))
    got = dia_matvec(diags, offsets, x)
    for b in range(3):
        assert torch.equal(got[b], dia_matvec(diags[b], offsets, x[b]))
        assert torch.equal(dia_matvec(diags, offsets, x[:, :, 0])[b],
                           dia_matvec(diags[b], offsets, x[b, :, 0]))
    with pytest.raises(ValueError, match="does not fit"):
        dia_matvec(diags, offsets, x[:2])


# ------------------------------------------------------ plateau scale
def _plateau_feed(kind: str):
    """A value sequence as the trainer feeds it: inf during the first
    epoch, then one value per epoch, repeated per step."""
    rng = np.random.default_rng(9)
    vals = [np.inf] * 8
    for epoch in range(14):
        if kind == "trainer":  # falls, then noise around a plateau
            v = 1.0 / (1 + epoch) if epoch < 5 else 0.2 + 0.01 * rng.random()
        elif kind == "flat":  # one improvement, then two reductions
            v = 0.5
        else:  # "below-rtol": steps smaller than rtol, then larger ones
            v = (1.0 - 5e-5) ** epoch if epoch < 8 else 0.9 ** epoch
        vals += [v] * 4
    if kind == "first-epoch":  # a first epoch longer than the patience
        vals = [np.inf] * 25 + vals[8:]
    return vals


@pytest.mark.parametrize("kind", ["trainer", "flat", "below-rtol",
                                  "first-epoch"])
def test_plateau_scale_follows_optax(kind):
    """`PlateauScale` gives the scale sequence of optax's
    reduce_on_plateau at the JAX trainer's settings (factor 0.1, patience
    10, the rest optax's defaults) exactly (float32), fed as the trainer
    feeds it."""
    from optax.contrib import reduce_on_plateau

    vals = _plateau_feed(kind)
    tx = reduce_on_plateau(factor=0.1, patience=10)
    params = {"w": jnp.zeros(1)}
    state = tx.init(params)
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=0.5)
    ps = t_train.PlateauScale(opt)
    scales = []
    update = jax.jit(lambda st, v: tx.update({"w": jnp.ones(1)}, st, params,
                                            value=v)[1])
    for v in vals:
        state = update(state, jnp.asarray(v, jnp.float32))
        got = ps.step(v)
        assert np.float32(got) == np.float32(state.scale), (len(scales), kind)
        assert opt.param_groups[0]["lr"] == 0.5 * got
        scales.append(got)
    assert min(scales) < 1.0  # the sequence did reduce


# ------------------------------------------------------ training runs
BASE = dict(num_matrices=16, n_mesh=10, epochs=3, batch_size=8, n_train=12,
            n_val=2, n_test=2, m_probes=8, cache_dir=None, log_every=0)


@pytest.mark.parametrize("layout", ["dia", "stencil"])
def test_train_matches_jax(layout):
    """`train` on a tiny config from the same carried init and numpy
    seed: the same batches and probes, and the JAX loss history."""
    pj = jparams(0)
    cfg = dict(BASE, loss_layout=layout)
    _, hj = j_train.train(j_train.TrainJacobiConfig(**cfg), init_params=pj)
    model, ht = t_train.train(t_train.TrainJacobiConfig(**cfg),
                              init_params=params_from_jax(pj), device=CPU)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(ht[key], hj[key], rtol=1e-3)
    np.testing.assert_allclose(ht["test_loss"], hj["test_loss"], rtol=1e-3)
    assert ht["train_loss"][-1] < ht["train_loss"][0]
    assert isinstance(model, t_tj.TrainableJacobiMLP)


def test_train_with_stability_penalty_matches_jax(tmp_path):
    pj = jparams(2)
    cfg = dict(BASE, epochs=2, m_probes=6, stability_weight=2.0,
               stability_k=6)
    _, hj = j_train.train(j_train.TrainJacobiConfig(**cfg), init_params=pj)
    model, ht = t_train.train(
        t_train.TrainJacobiConfig(**cfg, checkpoint_dir=str(tmp_path)),
        init_params=params_from_jax(pj), device=CPU)
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(ht[key], hj[key], rtol=1e-3)
    assert np.isfinite(ht["test_loss"])
    fresh = t_tj.TrainableJacobiMLP(device=CPU)
    metrics = load_checkpoint(str(tmp_path / "epoch_0001.pt"), fresh)
    assert metrics == {"val_loss": ht["val_loss"][-1]}


def test_train_refuses_data_parallel_and_unknown_layouts(datasets):
    """Data-parallel training needs a "data" mesh or a process group of
    n_devices ranks (tests/test_torch_parallel_train.py runs it)."""
    _, dt = datasets
    with pytest.raises(RuntimeError, match="initialized process group"):
        t_train.train(t_train.TrainJacobiConfig(**BASE, n_devices=8),
                      device=CPU)
    with pytest.raises(TypeError, match="'data' axis"):
        t_train.train(t_train.TrainJacobiConfig(**BASE), mesh=object(),
                      device=CPU)
    with pytest.raises(ValueError, match="loss layout"):
        t_train.make_loss_fn(port_mlp(jparams()), dt, OMEGA, 3,
                             layout="ell")


def test_evaluate_vs_baselines_matches_jax(datasets):
    dj, dt = datasets
    pj = jparams(4)
    cfg_j = j_train.TrainJacobiConfig(**BASE)
    want = j_train.evaluate_vs_baselines(pj, dj, cfg_j, max_graphs=2)
    got = t_train.evaluate_vs_baselines(params_from_jax(pj), dt,
                                        t_train.TrainJacobiConfig(**BASE),
                                        max_graphs=2)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
