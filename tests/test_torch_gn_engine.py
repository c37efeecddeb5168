"""Parity of the port's GN-block engine (gnnla_tpu_torch.core), its
conversions, batching, `sddmm`/`scale` and the Laplacian generators with
the JAX package on the CPU.

The same seeded numpy inputs go through both packages. Tolerance rtol
1e-5, atol 1e-6 (f32 on both sides, sums in different orders); host
assembly (triplets, vertices, Dirichlet counts, batch ids) is identical.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import gnnla_tpu.core as jc
import gnnla_tpu_torch.core as tc
from gnnla_tpu.ops.sparse import SparseOperator as JSparse
from gnnla_tpu.problems import laplacian as jlap
from gnnla_tpu_torch.ops.sparse import SparseOperator as TSparse
from gnnla_tpu_torch.problems import laplacian as tlap

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _mixed_scipy():
    """Three graphs of different sizes and patterns (the JAX package's
    batching fixture), as scipy matrices."""
    return [jlap.laplacian_2d(4).to_scipy(), jlap.laplacian_2d(5).to_scipy(),
            jlap.laplacian_nd((3, 3), bcs=(1, 1))[0].to_scipy()]


def _ops(mats):
    return ([JSparse.from_scipy(m) for m in mats],
            [TSparse.from_scipy(m, device=CPU) for m in mats])


# ------------------------------------------------------------ containers
def test_graph_state_and_columns():
    rng = np.random.default_rng(0)
    v, e = rng.standard_normal((6, 3)), rng.standard_normal((9, 2))
    s = tc.GraphState(vertices=_t(v), edges=_t(e))
    assert (s.n_vertices, s.n_edges) == (6, 9)
    close(s.vertex_col(1), v[:, 1], 0, 0)
    close(s.edge_col(1), e[:, 1], 0, 0)
    s2 = s.replace(globals_=torch.ones(2))
    assert s.globals_ is None and s2.vertices is s.vertices
    with pytest.raises(Exception):  # frozen, like the JAX dataclass
        s.vertices = None
    cols = [rng.standard_normal(5).astype(np.float32) for _ in range(3)]
    close(tc.columns(*[_t(c) for c in cols]),
          jc.columns(*[jnp.asarray(c) for c in cols]), 0, 0)


def test_graph_batch_single():
    got = tc.GraphBatch.single(7, 11, device=CPU)
    want = jc.GraphBatch.single(7, 11)
    for name in ("vertex_graph", "edge_graph"):
        t, j = getattr(got, name), getattr(want, name)
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert got.n_graphs == want.n_graphs == 1
    assert got.vertex_mask is None and got.edge_mask is None


# ----------------------------------------------------------- the engine
def _fns(xp):
    """Edge, vertex and global updates written once for both packages:
    every aggregator reducer, the globals read per edge and per vertex
    (`g[..., k]` is a scalar column of one graph's [Fg] or a batch's
    gathered [E|N, Fg])."""
    cat = ((lambda xs, axis: torch.cat(xs, dim=axis)) if xp is torch
           else jnp.concatenate)

    def edge_fn(v_i, v_j, e, g):
        return cat([e, e[:, :1] * v_j[:, :1] - v_i[:, 1:2] * g[..., :1]], 1)

    def vertex_fn(v, e, agg, g):
        return cat([v, agg.sum(e[:, 1:]), agg.max(e[:, :1]),
                    agg.min(e[:, 1:2]), agg.mean(e[:, :1]) * g[..., 1:2],
                    agg.multi(("sum", "max"), e[:, 0])], 1)

    def global_fn(v, e, g, vagg, eagg):
        return cat([g[..., :1] + vagg.sum(v[:, :1]), eagg.max(e[:, 1:2]),
                    vagg.min(v[:, 1:2]), eagg.mean(e[:, :1]),
                    vagg.multi(("mean", "sum"), v[:, 0])], -1)

    return types.SimpleNamespace(edge=edge_fn, vertex=vertex_fn,
                                 glob=global_fn)


def _state_inputs(n, nnz, n_graphs=None, seed=1):
    rng = np.random.default_rng(seed)
    g_shape = (2,) if n_graphs is None else (n_graphs, 2)
    return (rng.standard_normal((n, 2)).astype(np.float32),
            rng.standard_normal((nnz, 2)).astype(np.float32),
            rng.standard_normal(g_shape).astype(np.float32))


COMBOS = [(e, v, g) for e in (0, 1) for v in (0, 1) for g in (0, 1)]


def _blocks(combo):
    (e, v, g), fj, ft = combo, _fns(jnp), _fns(torch)
    return (jc.GNBlock(fj.edge if e else None, fj.vertex if v else None,
                       fj.glob if g else None),
            tc.GNBlock(ft.edge if e else None, ft.vertex if v else None,
                       ft.glob if g else None))


def _compare_states(got, want):
    for name in ("vertices", "edges", "globals_"):
        close(getattr(got, name).numpy(), getattr(want, name))


@pytest.mark.parametrize("combo", COMBOS,
                         ids=lambda c: "e%d_v%d_g%d" % c)
def test_gn_block_single_graph(combo):
    """Every combination of the three updates on one graph (the dense row
    layout aggregates)."""
    (m,) = _mixed_scipy()[:1]
    (opj,), (opt,) = _ops([m])
    v, e, g = _state_inputs(opj.n_rows, opj.nnz)
    bj, bt = _blocks(combo)
    want = bj(opj, jc.GraphState(jnp.asarray(v), jnp.asarray(e),
                                 jnp.asarray(g)))
    got = bt(opt, tc.GraphState(_t(v), _t(e), _t(g)))
    _compare_states(got, want)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("combo", COMBOS,
                         ids=lambda c: "e%d_v%d_g%d" % c)
def test_gn_block_batched(combo, masked):
    """Every combination on a block-diagonal batch with per-graph globals
    ([G, Fg], gathered per edge and per vertex); masks reach both
    aggregators (the segment path)."""
    (opsj, opst) = _ops(_mixed_scipy())
    bigj, batchj = jc.batch_operators(opsj)
    bigt, batcht = tc.batch_operators(opst)
    v, e, g = _state_inputs(bigj.n_rows, bigj.nnz, n_graphs=3)
    if masked:
        rng = np.random.default_rng(2)
        vm = rng.random(bigj.n_rows) > 0.2
        em = rng.random(bigj.nnz) > 0.2
        batchj = jc.GraphBatch(batchj.vertex_graph, batchj.edge_graph, 3,
                               jnp.asarray(vm), jnp.asarray(em))
        batcht = tc.GraphBatch(batcht.vertex_graph, batcht.edge_graph, 3,
                               _t(vm), _t(em))
    bj, bt = _blocks(combo)
    want = bj(bigj, jc.GraphState(jnp.asarray(v), jnp.asarray(e),
                                  jnp.asarray(g)), batchj)
    got = bt(bigt, tc.GraphState(_t(v), _t(e), _t(g)), batcht)
    _compare_states(got, want)


def test_batched_block_equals_single_graph_calls():
    """Per-graph globals on a batch give each graph's single-graph call."""
    mats = _mixed_scipy()
    _, opst = _ops(mats)
    big, batch = tc.batch_operators(opst)
    v, e, g = _state_inputs(big.n_rows, big.nnz, n_graphs=3)
    _, blk = _blocks((1, 1, 1))
    out = blk(big, tc.GraphState(_t(v), _t(e), _t(g)), batch)
    vs = tc.unbatch_vertices(out.vertices, tc.graph_sizes(opst))
    es = tc.unbatch_vertices(out.edges, [op.nnz for op in opst])
    v_off = e_off = 0
    for k, op in enumerate(opst):
        one = blk(op, tc.GraphState(_t(v[v_off:v_off + op.n_rows]),
                                    _t(e[e_off:e_off + op.nnz]), _t(g[k])))
        close(vs[k], one.vertices)
        close(es[k], one.edges)
        close(out.globals_[k], one.globals_)
        v_off += op.n_rows
        e_off += op.nnz


def test_chain():
    (m,) = _mixed_scipy()[2:]
    (opj,), (opt,) = _ops([m])
    v, e, g = _state_inputs(opj.n_rows, opj.nnz)
    pairs = [_blocks(c) for c in ((1, 1, 0), (0, 1, 1), (1, 0, 1))]
    want = jc.chain([p[0] for p in pairs], opj,
                    jc.GraphState(jnp.asarray(v), jnp.asarray(e),
                                  jnp.asarray(g)))
    st = tc.GraphState(_t(v), _t(e), _t(g))
    got = tc.chain([p[1] for p in pairs], opt, st)
    _compare_states(got, want)
    for _, blk in pairs:  # chain is the blocks in order
        st = blk(opt, st)
    _compare_states(got, st)
    assert tc.chain([], opt, st) is st


@pytest.mark.parametrize("reducer", ["sum", "mean", "max", "min", "multi"])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("ndim", [1, 2])
def test_node_aggregator(reducer, batched, masked, ndim):
    """Full-array reductions for one graph (max/min of masked data are
    the masked extremes, not 0); segment reductions over the batch ids,
    an empty graph (id 3 of 5) giving 0 as the JAX package's."""
    rng = np.random.default_rng(3)
    n = 40
    data = rng.standard_normal((n, 3) if ndim == 2 else n).astype(np.float32)
    ids = rng.choice([0, 1, 2, 4], size=n).astype(np.int32)
    mask = rng.random(n) > 0.3
    args_j = (jnp.asarray(ids) if batched else None, 5 if batched else 1)
    args_t = (_t(ids) if batched else None, 5 if batched else 1)
    aj = jc.NodeAggregator(*args_j, mask=jnp.asarray(mask) if masked
                           else None)
    at = tc.NodeAggregator(*args_t, mask=_t(mask) if masked else None)
    if reducer == "multi":
        want = aj.multi(("min", "mean", "sum", "max"), jnp.asarray(data))
        got = at.multi(("min", "mean", "sum", "max"), _t(data))
    else:
        want = getattr(aj, reducer)(jnp.asarray(data))
        got = getattr(at, reducer)(_t(data))
    assert tuple(got.shape) == tuple(want.shape)
    close(got, want)


def test_node_aggregator_single_all_masked():
    """One graph, every vertex masked: max is -inf and min +inf (the
    masked fill), mean divides by max(count, 1)."""
    data = np.arange(6, dtype=np.float32)
    mask = np.zeros(6, bool)
    aj = jc.NodeAggregator(None, 1, mask=jnp.asarray(mask))
    at = tc.NodeAggregator(None, 1, mask=_t(mask))
    for r in ("sum", "mean", "max", "min"):
        want = np.asarray(getattr(aj, r)(jnp.asarray(data)))
        got = getattr(at, r)(_t(data)).numpy()
        np.testing.assert_array_equal(got, want)
    assert float(at.max(_t(data))) == float("-inf")


def test_edge_aggregator_path_choice():
    """The dense row layout where the JAX package takes it, the segment
    aggregator with a mask or another vertex count."""
    from gnnla_tpu_torch.ops.segment import DenseRowLayout

    _, (op,) = _ops(_mixed_scipy()[:1])
    assert isinstance(tc.make_edge_aggregator(op, op.n_rows), DenseRowLayout)
    mask = torch.ones(op.nnz, dtype=torch.bool)
    assert isinstance(tc.make_edge_aggregator(op, op.n_rows, mask),
                      tc.EdgeAggregator)
    assert isinstance(tc.make_edge_aggregator(op, op.n_rows + 1),
                      tc.EdgeAggregator)


# ---------------------------------------------------------- conversions
def _rand_dense(seed=4, n=9):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) * (rng.random((n, n)) < 0.35)
    return a + np.diag(rng.random(n) + 4.0)


def test_as_operator():
    a = _rand_dense()
    for src in (a, sp.csr_matrix(a)):
        got = tc.as_operator(src, device=CPU)
        want = jc.as_operator(src)
        for x, y in zip(got.host_coo(), want.host_coo()):
            np.testing.assert_array_equal(x, y)
        close(got.vals, want.vals, 0, 0)
        assert got.device.type == "cpu"
    assert tc.as_operator(got) is got


def test_coo_to_gnn_input_and_remove_diag():
    a = _rand_dense(5)
    ij_t, e_t = tc.coo_to_gnn_input(a, device=CPU)
    ij_j, e_j = jc.coo_to_gnn_input(a)
    np.testing.assert_array_equal(ij_t.numpy(), np.asarray(ij_j))
    close(e_t, e_j, 0, 0)
    assert tuple(e_t.shape) == tuple(e_j.shape)
    (ij_t2, e_t2), (ij_j2, e_j2) = (tc.remove_diag_entries(ij_t, e_t),
                                    jc.remove_diag_entries(ij_j, e_j))
    np.testing.assert_array_equal(ij_t2.numpy(), np.asarray(ij_j2))
    close(e_t2, e_j2, 0, 0)
    assert not bool((ij_t2[0] == ij_t2[1]).any())
    # numpy input: CPU tensors
    ij_n, _ = tc.remove_diag_entries(np.asarray(ij_j), np.asarray(e_j))
    np.testing.assert_array_equal(ij_n.numpy(), np.asarray(ij_j2))


@pytest.mark.parametrize("with_coords", [False, True],
                         ids=["plain", "coords"])
def test_matrix_to_graph_and_back(with_coords):
    m = jlap.laplacian_2d(5).to_scipy()
    coords = jlap.grid_coords_2d(5) if with_coords else None
    vt, ijt, et, opt = tc.matrix_to_graph(m, coords=coords, device=CPU)
    vj, ijj, ej, opj = jc.matrix_to_graph(m, coords=coords)
    close(vt, vj, 0, 0)
    np.testing.assert_array_equal(ijt.numpy(), np.asarray(ijj))
    close(et, ej)
    assert tuple(et.shape) == tuple(ej.shape)
    for x, y in zip(opt.host_coo(), opj.host_coo()):
        np.testing.assert_array_equal(x, y)
    # the inverse, with the stored and with new edge values
    new_vals = np.random.default_rng(6).standard_normal(opj.nnz)
    for ev in (None, new_vals):
        back_t = tc.graph_to_matrix(vt[:, 0], opt, ev)
        back_j = jc.graph_to_matrix(vj[:, 0], opj, ev)
        assert back_t.shape == back_j.shape
        for x, y in zip(back_t.host_coo(), back_j.host_coo()):
            np.testing.assert_allclose(x, y, rtol=1e-7)
        close(back_t.vals, back_j.vals, 0, 0)
    full = tc.graph_to_matrix(vt, opt)
    close(full.to_dense(), m.toarray(), 0, 0)


def test_graph_state_from_matrix():
    m = jlap.laplacian_2d(4).to_scipy()
    opt, st = tc.graph_state_from_matrix(m, n_vertex_features=3, device=CPU)
    opj, sj = jc.graph_state_from_matrix(m, n_vertex_features=3)
    close(st.vertices, sj.vertices, 0, 0)
    close(st.edges, sj.edges, 0, 0)
    assert st.globals_ is None and sj.globals_ is None
    assert opt.nnz == opj.nnz


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tc.as_operator(_rand_dense()),
                 lambda: tc.matrix_to_graph(_rand_dense()),
                 lambda: tc.graph_state_from_matrix(_rand_dense()),
                 lambda: tc.coo_to_gnn_input(_rand_dense()),
                 lambda: tc.GraphBatch.single(3, 4),
                 lambda: tlap.laplacian_nd((3, 3))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# -------------------------------------------------------------- batching
def test_batch_operators():
    opsj, opst = _ops(_mixed_scipy())
    bigj, bj = jc.batch_operators(opsj)
    bigt, bt = tc.batch_operators(opst)
    assert bigt.shape == bigj.shape and bt.n_graphs == bj.n_graphs == 3
    for x, y in zip(bigt.host_coo(), bigj.host_coo()):
        np.testing.assert_array_equal(x, y)
    for name in ("vertex_graph", "edge_graph"):
        assert getattr(bt, name).dtype == torch.int32
        np.testing.assert_array_equal(getattr(bt, name).numpy(),
                                      np.asarray(getattr(bj, name)))
    np.testing.assert_array_equal(bigt.row_ptr.numpy(),
                                  np.asarray(bigj.row_ptr))
    assert bool((bigt.rows.diff() >= 0).all())
    assert tc.graph_sizes(opst) == jc.graph_sizes(opsj) == [16, 25, 9]
    with pytest.raises(ValueError):
        tc.batch_operators([])
    with pytest.raises(ValueError, match="square"):
        tc.batch_operators([TSparse.from_dense(np.ones((2, 3)), device=CPU)])


def test_batch_states_and_unbatch():
    rng = np.random.default_rng(8)
    parts = [tuple(a.astype(np.float32) for a in (
        rng.standard_normal((n, 2)), rng.standard_normal((m, 1)),
        rng.standard_normal(2))) for n, m in ((3, 5), (4, 2), (2, 7))]
    want = jc.batch_states([jc.GraphState(*(jnp.asarray(a) for a in p))
                            for p in parts])
    got = tc.batch_states([tc.GraphState(*(_t(a) for a in p))
                           for p in parts])
    _compare_states(got, want)
    assert tuple(got.globals_.shape) == (3, 2)
    no_g = tc.batch_states([tc.GraphState(vertices=_t(p[0]))
                            for p in parts])
    assert no_g.globals_ is None and no_g.edges is None
    sizes = [3, 4, 2]
    for axis, arr in ((0, got.vertices), (1, got.vertices.T)):
        want_parts = jc.unbatch_vertices(jnp.asarray(arr.numpy()), sizes,
                                         axis=axis)
        for a, b in zip(tc.unbatch_vertices(arr, sizes, axis=axis),
                        want_parts):
            close(a, b, 0, 0)


def test_batched_matvec_matches_per_graph():
    from gnnla_tpu_torch.models import matvec

    _, opst = _ops(_mixed_scipy())
    big, _ = tc.batch_operators(opst)
    sizes = tc.graph_sizes(opst)
    rng = np.random.default_rng(9)
    xs = [_t(rng.random(n).astype(np.float32)) for n in sizes]
    y = tc.unbatch_vertices(matvec(big, torch.cat(xs)), sizes)
    for op, x, yk in zip(opst, xs, y):
        close(yk, matvec(op, x))


# ------------------------------------------------------ sddmm and scale
@pytest.mark.parametrize("f", [1, 4])
def test_sddmm(f):
    a = _rand_dense(10, 12)
    opj, opt = JSparse.from_dense(a), TSparse.from_dense(a, device=CPU)
    rng = np.random.default_rng(11)
    shape = (12,) if f == 1 else (12, f)
    U = rng.standard_normal(shape).astype(np.float32)
    V = rng.standard_normal(shape).astype(np.float32)
    got = opt.sddmm(_t(U), _t(V))
    close(got, opj.sddmm(jnp.asarray(U), jnp.asarray(V)))
    dense = (U.reshape(12, -1) @ V.reshape(12, -1).T)
    r, c, _ = opt.host_coo()
    close(got, dense[r, c])


def test_scale_keeps_the_host_cache():
    a = _rand_dense(12)
    opj, opt = JSparse.from_dense(a), TSparse.from_dense(a, device=CPU)
    for s in (-1.0, 3, torch.tensor(2.0)):
        got = opt.scale(s)
        want = opj.scale(s if not isinstance(s, torch.Tensor)
                         else jnp.asarray(2.0))
        close(got.vals, want.vals, 0, 0)
        if isinstance(s, (int, float)):
            np.testing.assert_array_equal(got.host_coo()[2],
                                          opt.host_coo()[2] * s)
        else:  # a tensor scale leaves no cache; host_coo reads back
            assert got._host_coo is None
    assert opt.scale(2.0)._row_layout is opt._row_layout


# --------------------------------------------------- problem generators
ND_CASES = [((7,), None), ((6,), (1,)), ((3, 4), None), ((3, 4), (1, 0)),
            ((3, 3), (1, 1)), ((4, 5), (0, 1)), ((2, 3, 4), None),
            ((3, 3, 3), (1, 1, 1)), ((2, 3, 4), (0, 1, 0))]


@pytest.mark.parametrize("npts,bcs", ND_CASES,
                         ids=lambda v: "x".join(map(str, v)) if v else "dir")
def test_laplacian_nd(npts, bcs):
    opt, vt, dnt = tlap.laplacian_nd(npts, bcs, device=CPU)
    opj, vj, dnj = jlap.laplacian_nd(npts, bcs)
    assert opt.shape == opj.shape
    for x, y in zip(opt.host_coo(), opj.host_coo()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(opt.vals.numpy(), np.asarray(opj.vals))
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(dnt, dnj)


@pytest.mark.parametrize("n", [1, 4, 9])
def test_grid_coords_2d(n):
    np.testing.assert_array_equal(tlap.grid_coords_2d(n),
                                  jlap.grid_coords_2d(n))


def test_exports():
    """The port's core exports every name of the JAX package's core, and
    its models every name of the JAX package's models."""
    import gnnla_tpu.models as jm
    import gnnla_tpu_torch.models as tm

    assert set(jc.__all__) <= set(tc.__all__)
    assert set(jm.__all__) <= set(tm.__all__)
    for mod in (tc, tm):
        assert all(hasattr(mod, name) for name in mod.__all__)
