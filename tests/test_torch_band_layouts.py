"""The port's band-family edge layouts (ops/band.py) against the JAX
package on the CPU: `BandLayout`, `GridBandLayout` and `EllLayout` packing,
their patterns' neighbour reads, broadcasts and reductions, the free
functions, and `choose_edge_layout`'s choice, warning and refusal.

Three patterns, made from numpy seeds: the periodic diffusion FEM on a
6 x 6 grid (uniform: grid), a small-band FEM (banded: band) and a random
unstructured graph (ell). The port's patterns take a batch of graphs
[B, K, N, F]; JAX's take one graph, so JAX runs graph by graph.

Tolerances: host packing identical; reductions rtol 1e-6 (atol 1e-6 *
max|want|: f32 sums in another order).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnla_tpu.ops import band as j_band
from gnnla_tpu.ops.sparse import SparseOperator as JSparse
from gnnla_tpu.problems.diffusion_fem import \
    cosine_diffusion_matrix as j_cosine_matrix
from gnnla_tpu.problems.small_band import small_band_matrix as j_small_band
from gnnla_tpu_torch.ops import band as t_band
from gnnla_tpu_torch.ops.sparse import SparseOperator as TSparse

CPU = "cpu"
REDUCES = ("min", "mean", "sum", "max")
KINDS = ("grid", "band", "ell")
GRID = (6, 6)


def assert_close(got, want, rtol=1e-6, atol_scale=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * np.abs(want).max())


def _unstructured_coo(n=40, k=3, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, size=n * k)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    key = np.unique(rows * n + cols)
    return key // n, key % n, rng.standard_normal(key.size), (n, n)


def _ops(kind):
    """(JAX operator, port operator) of one pattern, off-diagonal part."""
    if kind == "grid":
        j_op = j_cosine_matrix((1.0, 0.5, 2.0, 1.5), GRID[0])
    elif kind == "band":
        j_op, _, _ = j_small_band(8, 0.01, 0.4)
    else:
        r, c, v, shape = _unstructured_coo()
        j_op = JSparse.from_coo(r, c, v, shape)
    j_op = j_op.remove_diagonal()
    r, c, v = j_op.host_coo()
    t_op = TSparse.from_coo(r, c, v, j_op.shape, coalesce=False, device=CPU)
    return j_op, t_op


def _layouts(kind):
    j_op, t_op = _ops(kind)
    if kind == "grid":
        return (j_band.GridBandLayout(j_op, *GRID),
                t_band.GridBandLayout(t_op, *GRID))
    if kind == "band":
        return j_band.BandLayout(j_op), t_band.BandLayout(t_op)
    return j_band.EllLayout.from_operator(j_op), \
        t_band.EllLayout.from_operator(t_op)


def _patterns(kind):
    jl, tl = _layouts(kind)
    if kind == "grid":
        return jl, j_band.GridPattern.from_layout(jl), \
            t_band.GridPattern.from_layout(tl)
    if kind == "band":
        return jl, j_band.BandPattern.from_layout(jl), \
            t_band.BandPattern.from_layout(tl, CPU)
    return jl, j_band.EllPattern.from_layout(jl), \
        t_band.EllPattern.from_layout(tl, CPU)


@pytest.mark.parametrize("kind", KINDS)
def test_pack_unpack_identical(kind):
    jl, tl = _layouts(kind)
    assert (jl.n, jl.k, jl.n_edges) == (tl.n, tl.k, tl.n_edges)
    vals = np.random.default_rng(1).standard_normal((3, jl.n_edges))
    packed = tl.pack(vals)
    np.testing.assert_array_equal(packed, jl.pack(vals))
    np.testing.assert_array_equal(tl.unpack(packed), jl.unpack(packed))
    np.testing.assert_array_equal(tl.unpack(packed), vals)
    with pytest.raises(ValueError, match="n_edges"):
        tl.pack(vals[:, 1:])
    if kind == "band":
        assert jl.offsets == tl.offsets
        np.testing.assert_array_equal(jl.mask, tl.mask)
        np.testing.assert_array_equal(jl.deg, tl.deg)
    elif kind == "grid":
        assert jl.shifts == tl.shifts
    else:
        np.testing.assert_array_equal(jl.cols_ell, tl.cols_ell)
        np.testing.assert_array_equal(jl.deg, tl.deg)


def test_grid_layout_refuses_non_uniform_patterns():
    j_op, t_op = _ops("band")
    n = t_op.n_rows
    with pytest.raises(ValueError, match="not uniform|n_rows"):
        j_band.GridBandLayout(j_op, n, 1)
    with pytest.raises(ValueError, match="not uniform|n_rows"):
        t_band.GridBandLayout(t_op, n, 1)
    with pytest.raises(ValueError, match="n_rows"):
        t_band.GridBandLayout(t_op, 2, 2)


@pytest.mark.parametrize("kind", KINDS)
def test_pattern_methods_match(kind):
    """neighbor / broadcast / mask_pads / multi / global_multi on a batch
    of two graphs against JAX's single-graph pattern, graph by graph."""
    jl, jp, tp = _patterns(kind)
    rng = np.random.default_rng(2)
    b, f = 2, 3
    x = rng.standard_normal((b, jl.n, f)).astype(np.float32)
    e = rng.standard_normal((b, jl.k, jl.n, f)).astype(np.float32)
    xt, et = torch.from_numpy(x), torch.from_numpy(e)
    assert tp.k == jp.k and tp.n_edges == jp.n_edges
    got = {"neighbor": tp.neighbor(xt), "broadcast": tp.broadcast(xt),
           "mask_pads": tp.mask_pads(et), "multi": tp.multi(REDUCES, et),
           "global_multi": tp.global_multi(REDUCES, et)}
    for i in range(b):
        want = {"neighbor": jp.neighbor(jnp.asarray(x[i])),
                "broadcast": jp.broadcast(jnp.asarray(x[i])),
                "mask_pads": jp.mask_pads(jnp.asarray(e[i])),
                "multi": jp.multi(REDUCES, jnp.asarray(e[i])),
                "global_multi": jp.global_multi(REDUCES, jnp.asarray(e[i]))}
        for name, w in want.items():
            g = got[name][i].numpy()
            assert g.shape == w.shape, name
            assert_close(g, w)


@pytest.mark.parametrize("f", [None, 2])
def test_band_free_functions_match(f):
    jl, tl = _layouts("band")
    rng = np.random.default_rng(3)
    shape = (jl.n,) if f is None else (jl.n, f)
    x = rng.standard_normal(shape).astype(np.float32)
    bands = rng.standard_normal((jl.k,) + shape).astype(np.float32)
    xt, bt = torch.from_numpy(x), torch.from_numpy(bands)
    mask = torch.from_numpy(jl.mask)
    deg = torch.from_numpy(np.maximum(jl.deg, 1).astype(np.float32))
    for off in (0, 2, -3, jl.n, -jl.n - 1):
        assert_close(t_band.band_shift(xt, off),
                     j_band.band_shift(jnp.asarray(x), off))
    assert_close(t_band.band_neighbor_values(xt, tl.offsets),
                 j_band.band_neighbor_values(jnp.asarray(x), jl.offsets))
    assert_close(t_band.band_broadcast(xt, 4),
                 j_band.band_broadcast(jnp.asarray(x), 4))
    assert_close(t_band.band_multi_reduce(REDUCES, bt, mask, deg),
                 j_band.band_multi_reduce(REDUCES, jnp.asarray(bands),
                                          jnp.asarray(jl.mask),
                                          jnp.asarray(deg.numpy())))
    assert_close(t_band.band_global_multi(REDUCES, bt, mask, tl.n_edges),
                 j_band.band_global_multi(REDUCES, jnp.asarray(bands),
                                          jnp.asarray(jl.mask), jl.n_edges))
    # band_spmv against the operator's own product
    packed = tl.pack(_ops("band")[1].host_coo()[2]).astype(np.float32)
    assert_close(t_band.band_spmv(torch.from_numpy(packed), tl.offsets, xt),
                 j_band.band_spmv(jnp.asarray(packed), jl.offsets,
                                  jnp.asarray(x)))


def test_ell_free_functions_match():
    jl, tl = _layouts("ell")
    rng = np.random.default_rng(4)
    slots = rng.standard_normal((jl.k, jl.n, 2)).astype(np.float32)
    deg_t = torch.from_numpy(tl.deg)
    np.testing.assert_array_equal(
        t_band.ell_mask(tl.k, deg_t).numpy(),
        np.asarray(j_band.ell_mask(jl.k, jnp.asarray(jl.deg))))
    assert_close(t_band.ell_multi_reduce(REDUCES, torch.from_numpy(slots),
                                         deg_t),
                 j_band.ell_multi_reduce(REDUCES, jnp.asarray(slots),
                                         jnp.asarray(jl.deg)))
    assert_close(t_band.ell_global_multi(REDUCES, torch.from_numpy(slots),
                                         deg_t, tl.n_edges),
                 j_band.ell_global_multi(REDUCES, jnp.asarray(slots),
                                         jnp.asarray(jl.deg), jl.n_edges))


def test_unknown_reducer_raises():
    _, _, tp = _patterns("grid")
    with pytest.raises(ValueError, match="unknown reducer"):
        tp.multi(("median",), torch.zeros(1, tp.k, 36, 1))


@pytest.mark.parametrize("kind", KINDS)
def test_choose_edge_layout_same_kind(kind):
    j_op, t_op = _ops(kind)
    grid = GRID if kind == "grid" else None
    jl, _, jk = j_band.choose_edge_layout(j_op, grid_shape=grid)
    tl, tp, tk = t_band.choose_edge_layout(t_op, grid_shape=grid)
    assert tk == jk == kind
    assert tl.k == jl.k and tp.k == jl.k
    vals = np.arange(jl.n_edges, dtype=np.float64)
    np.testing.assert_array_equal(tl.pack(vals), jl.pack(vals))


def test_choose_edge_layout_warns_on_fallback():
    j_op, t_op = _ops("band")
    n = t_op.n_rows
    with pytest.warns(UserWarning, match="grid layout requested") as jw:
        _, _, jk = j_band.choose_edge_layout(j_op, grid_shape=(n, 1))
    with pytest.warns(UserWarning, match="grid layout requested") as tw:
        _, _, tk = t_band.choose_edge_layout(t_op, grid_shape=(n, 1))
    assert tk == jk == "band"
    assert str(tw[0].message) == str(jw[0].message)


def test_choose_edge_layout_refuses_too_many_slots(monkeypatch):
    j_op, t_op = _ops("ell")
    monkeypatch.setattr(j_band, "ELL_MAX_SLOTS", 16)
    monkeypatch.setattr(t_band, "ELL_MAX_SLOTS", 16)
    with pytest.raises(ValueError) as je:
        j_band.choose_edge_layout(j_op)
    with pytest.raises(ValueError) as te:
        t_band.choose_edge_layout(t_op)
    assert str(te.value) == str(je.value)
    assert t_band.ELL_MAX_SLOTS == 16 and j_band.ELL_MAX_SLOTS == 16


def test_ell_max_slots_constant():
    assert t_band.ELL_MAX_SLOTS == j_band.ELL_MAX_SLOTS == 1 << 28


def test_patterns_from_operator_on_its_device():
    _, t_op = _ops("band")
    assert t_band.BandPattern.from_operator(t_op).mask.device.type == CPU
    _, t_op = _ops("ell")
    assert t_band.EllPattern.from_operator(t_op).cols.device.type == CPU
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, _, kind = t_band.choose_edge_layout(_ops("grid")[1],
                                               grid_shape=GRID)
    assert kind == "grid"
