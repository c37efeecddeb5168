"""Parity of the port's multilevel hierarchies and Krylov solvers
(gnnla_tpu_torch.amg.aggregation, .models.multigrid, .models.krylov,
.problems.fem_heateqn) with the JAX package on the CPU.

The same problems go through both packages: each package assembles its
own operator (asserted identical) and builds its own hierarchy, which
must come out identical — aggregates, levels, P and Ac patterns, f32
values, smoother diagonals and the coarsest Chebyshev interval — since
both run the same float64 host setup and cast once. The port's solvers
then run on the CPU (the kernels' plain versions, through the same
wrappers the card runs) against the JAX package's.

Tolerances: cycles rtol 1e-4, atol 1e-5 * max|x| (f32 sums in other
orders over several levels, as the JAX package's own DIA-vs-COO
hierarchy test allows); Krylov residual histories 1e-4 relative while
the residual is above 1e-5 ||b|| (below that both are f32 rounding).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnla_tpu import native_ext as j_native
from gnnla_tpu.amg import aggregation as ja
from gnnla_tpu.ops.dia import DIAOperator as JDia
from gnnla_tpu.problems import fem_heateqn as j_fem
from gnnla_tpu.problems import laplacian_2d as j_laplacian_2d
from gnnla_tpu_torch import native_ext as t_native
from gnnla_tpu_torch.amg import aggregation as ta
from gnnla_tpu_torch.ops.dia import DIAOperator as TDia
from gnnla_tpu_torch.ops.dia import to_dia
from gnnla_tpu_torch.ops.dia_spmv import DiaKernelOperator
from gnnla_tpu_torch.ops.stream_op import RectStreamOperator, StreamOperator
from gnnla_tpu_torch.problems import fem_heateqn as t_fem
from gnnla_tpu_torch.problems import laplacian_2d as t_laplacian_2d

jm = importlib.import_module("gnnla_tpu.models.multigrid")
tm = importlib.import_module("gnnla_tpu_torch.models.multigrid")
jk = importlib.import_module("gnnla_tpu.models.krylov")
tk = importlib.import_module("gnnla_tpu_torch.models.krylov")
jv = importlib.import_module("gnnla_tpu.models.vcycle")
tv = importlib.import_module("gnnla_tpu_torch.models.vcycle")

CPU = "cpu"
CASES = ["lap32", "fem32"]


@functools.lru_cache(maxsize=None)
def problem(case):
    """(JAX operator, port operator) of a test problem: the 32^2 FD
    Laplacian (with the explicit zeros its Kronecker sum emits) or the
    stretch-7 heat-equation FEM on 32 x 32 cells, eliminated Dirichlet."""
    if case == "lap32":
        return j_laplacian_2d(32), t_laplacian_2d(32, device=CPU)
    args = ((32, 32), (1.0, 7.0))
    return (j_fem.heateqn_fem_2d(*args, bcs=(2, 2)),
            t_fem.heateqn_fem_2d(*args, bcs=(2, 2), device=CPU))


@functools.lru_cache(maxsize=None)
def hierarchies(kind, case):
    A_j, A_t = problem(case)
    if kind == "sa":
        return (jm.setup_sa_multigrid(A_j, seed=0),
                tm.setup_sa_multigrid(A_t, seed=0))
    return jm.setup_multigrid(A_j), tm.setup_multigrid(A_t)


def vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def assert_close(got, want, rtol=1e-4, atol_scale=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * np.abs(want).max())


def assert_same_operator(op_t, op_j):
    """Identical shape, COO pattern and entry order, equal f32 values."""
    assert op_t.shape == op_j.shape
    np.testing.assert_array_equal(op_t.rows.numpy(), np.asarray(op_j.rows))
    np.testing.assert_array_equal(op_t.cols.numpy(), np.asarray(op_j.cols))
    np.testing.assert_array_equal(op_t.vals.numpy(), np.asarray(op_j.vals))


def host_csr(case):
    return problem(case)[1].to_scipy().tocsr()


# ------------------------------------------------------------ problems
@pytest.mark.parametrize("bcs,stretch", [((1, 1), 1.0), ((2, 2), 7.0),
                                         ((0, 1), 4.0), ((1, 0), 0.5)])
def test_heateqn_fem_identical(bcs, stretch):
    args = ((9, 7), (1.0, stretch), bcs)
    A_j = j_fem.heateqn_fem_2d(*args)
    A_t = t_fem.heateqn_fem_2d(*args, device=CPU)
    for got, want in zip(A_t.host_coo(), A_j.host_coo()):
        np.testing.assert_array_equal(got, want)
    assert_same_operator(A_t, A_j)
    assert_same_operator(t_fem.stretched_mesh_matrix(11, 3.0, device=CPU),
                         j_fem.stretched_mesh_matrix(11, 3.0))
    with pytest.raises(ValueError, match="eliminated"):
        t_fem.heateqn_fem_2d_host((4, 4), (1.0, 1.0), (2, 1))


# --------------------------------------------------------- aggregation
@pytest.mark.parametrize("case", CASES)
def test_sa_pieces_identical(case):
    """sa_strength, aggregate, tentative_prolongator, filtered_operator,
    dinv_a_lmax and smoothed_prolongator give the JAX package's arrays."""
    A = host_csr(case)
    for theta in (0.08, 0.04):
        S_j, S_t = ja.sa_strength(A, theta), ta.sa_strength(A, theta)
        for attr in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(S_t, attr),
                                          getattr(S_j, attr))
    agg = ta.aggregate(S_t)
    np.testing.assert_array_equal(agg, ja.aggregate(S_j))
    Ph_j, Ph_t = ja.tentative_prolongator(agg), ta.tentative_prolongator(agg)
    assert (Ph_t != Ph_j).nnz == 0
    Af_j, Af_t = ja.filtered_operator(A, S_j), ta.filtered_operator(A, S_t)
    assert (Af_t != Af_j).nnz == 0
    assert ta.dinv_a_lmax(Af_t, seed=3) == ja.dinv_a_lmax(Af_j, seed=3)
    P_j = ja.smoothed_prolongator(A, S_j, Ph_j)
    P_t = ta.smoothed_prolongator(A, S_t, Ph_t)
    for attr in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(P_t, attr), getattr(P_j, attr))


@pytest.mark.parametrize("case", CASES)
def test_aggregate_native_and_fallback_identical(case, monkeypatch):
    """The native scan and the numpy fallback give the same aggregates in
    both packages."""
    S = ta.sa_strength(host_csr(case), 0.08)
    native = ta.aggregate(S)
    assert t_native.available() == j_native.available()
    monkeypatch.setattr(t_native, "vanek_aggregate", lambda G: None)
    monkeypatch.setattr(j_native, "vanek_aggregate", lambda G: None)
    fallback_t, fallback_j = ta.aggregate(S), ja.aggregate(S)
    np.testing.assert_array_equal(fallback_t, fallback_j)
    np.testing.assert_array_equal(fallback_t, native)
    assert native.min() == 0 and np.bincount(native).min() > 0


# --------------------------------------------------------- hierarchies
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", ["classical", "sa"])
def test_hierarchy_identical(kind, case):
    s_j, s_t = hierarchies(kind, case)
    assert s_t.n_levels == s_j.n_levels >= 3
    for a_t, a_j in zip(s_t.As, s_j.As):
        assert_same_operator(a_t, a_j)
    for p_t, p_j in zip(s_t.Ps, s_j.Ps):
        assert_same_operator(p_t, p_j)
    for d_t, d_j in zip(s_t.diags, s_j.diags):
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert (s_t.coarse_c, s_t.coarse_d) == (s_j.coarse_c, s_j.coarse_d)


def test_trained_diagonal_applies_to_the_finest_level_only():
    A_j, A_t = problem("lap32")
    d = (np.asarray(A_j.diagonal()) * np.linspace(0.8, 1.2, 1024)).astype(
        np.float32)
    for setup in (tm.setup_sa_multigrid, tm.setup_multigrid):
        s = setup(A_t, diag=torch.from_numpy(d))
        np.testing.assert_array_equal(s.diags[0].numpy(), d)
        np.testing.assert_array_equal(s.diags[1].numpy(),
                                      s.As[1].host_diagonal().astype(
                                          np.float32))


# -------------------------------------------------------------- cycles
@pytest.mark.parametrize("kind,case,gamma", [
    ("classical", "lap32", 1), ("classical", "fem32", 1),
    ("sa", "lap32", 1), ("sa", "fem32", 1),
    ("sa", "lap32", 2), ("sa", "fem32", 2)])
def test_cycles_match(kind, case, gamma):
    """multigrid_cycle (V and W) and multigrid_solve; JAX's solve is its
    cycle scanned, so its cycle, jitted once, is iterated here (the eager
    JAX cycle compiles each of its small ops on first use)."""
    s_j, s_t = hierarchies(kind, case)
    n = s_t.As[0].n_rows
    b, x0 = vec(n, 1), vec(n, 2)
    kw = dict(n_pre=2, n_post=2, gamma=gamma)
    cycle_j = jax.jit(functools.partial(jm.multigrid_cycle, **kw))
    bj, bt = jnp.asarray(b), torch.from_numpy(b)
    assert_close(tm.multigrid_cycle(s_t, bt, torch.from_numpy(x0), **kw),
                 cycle_j(s_j, bj, jnp.asarray(x0)))
    want = jnp.zeros(n)
    for _ in range(3):
        want = cycle_j(s_j, bj, want)
    assert_close(tm.multigrid_solve(s_t, bt, torch.zeros(n), n_cycles=3,
                                    **kw), want)


def test_two_level_multigrid_matches_vcycle():
    """A hierarchy cut to two levels with the reference's options and
    interval is the two-grid cycle."""
    A = t_laplacian_2d(10, device=CPU)
    mg = tm.setup_multigrid(A, min_coarse=99, max_levels=2,
                            splitting="cljp", interp="reference", trunc=0.0)
    assert mg.n_levels == 2
    b, x0 = torch.from_numpy(vec(100, 3)), torch.from_numpy(vec(100, 4))
    got = tm.multigrid_cycle(mg, b, x0, n_pre=3, n_post=3, coarse_deg=4,
                             coarse_c=-3.4, coarse_d=-4.0)
    want = tv.vcycle(tv.setup_twogrid(A), b, x0, coarse_deg=4)
    assert_close(got, want, atol_scale=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_dia_hierarchy_matches(case, monkeypatch):
    """setup_with_dia_multigrid swaps the same levels to DIA with the same
    diagonals; kernel=True puts exactly those on K1; mg_pcg on them
    follows JAX's (JAX's own tests hold its DIA hierarchy to its COO
    one). Each K1 level that smooths runs its two sweeps and its residual
    through K1's fused forms, 3 calls a V(1,1) cycle, one cycle more than
    iterations; a K1 coarsest level (Chebyshev) none."""
    s_j, s_t = hierarchies("sa", case)
    # one diagonal fewer than the widest level has: that level keeps COO
    cap = max(len(to_dia(a, None).offsets) for a in s_t.As) - 1
    d_j = jm.setup_with_dia_multigrid(s_j, max_offsets=cap)
    d_t = tm.setup_with_dia_multigrid(s_t, max_offsets=cap)
    k_t = tm.setup_with_dia_multigrid(s_t, max_offsets=cap, kernel=True)
    is_dia = [isinstance(a, JDia) for a in d_j.As]
    assert any(is_dia) and not all(is_dia)
    assert [isinstance(a, TDia) for a in d_t.As] == is_dia
    assert [isinstance(a, DiaKernelOperator) for a in k_t.As] == is_dia
    for a_t, a_k, a_j in zip(d_t.As, k_t.As, d_j.As):
        if isinstance(a_j, JDia):
            assert a_t.offsets == a_k.offsets == a_j.offsets
            np.testing.assert_array_equal(a_t.diags.numpy(),
                                          np.asarray(a_j.diags))
    fused = {id(a): 0 for a in k_t.As}
    for name in ("jacobi_sweep", "residual"):
        def counted(self, *args, _real=getattr(DiaKernelOperator, name)):
            fused[id(self)] += 1
            return _real(self, *args)
        monkeypatch.setattr(DiaKernelOperator, name, counted)
    x_j, h_j = jax_mg_pcg("sa", case)
    n = s_t.As[0].n_rows
    x_t, h_t = tk.mg_pcg(k_t, torch.from_numpy(vec(n, 6)), torch.zeros(n),
                         n_iters=15, flip_sign=case == "lap32")
    assert_history(h_t, h_j, vec(n, 6))
    assert_close(x_t, x_j)
    last = k_t.n_levels - 1
    assert [fused[id(a)] for a in k_t.As] == [
        3 * 16 if k1 and lvl < last else 0
        for lvl, k1 in enumerate(is_dia)]
    assert all(a.launches == a.fused_launches == 0 for a in k_t.As
               if isinstance(a, DiaKernelOperator))


@pytest.mark.parametrize("case", CASES)
def test_kernel_hierarchy_puts_the_rest_on_k2(case):
    """kernel=True puts each level `to_dia` refuses and every P on kernel
    K2 in their own order: a level as a forward-only StreamOperator (the
    COO's CSR, no transpose kept, so rmatvec and x's gradient raise), a P
    as a RectStreamOperator (CSRs of P and P^T); each applies as its COO
    does, and mg_pcg on the hierarchy follows JAX's (whose levels and Ps
    stay COO)."""
    _, s_t = hierarchies("sa", case)
    cap = max(len(to_dia(a, None).offsets) for a in s_t.As) - 1
    k_t = tm.setup_with_dia_multigrid(s_t, max_offsets=cap, kernel=True)
    refused = [not isinstance(a, DiaKernelOperator) for a in k_t.As]
    assert any(refused) and not all(refused)
    for a_k, a_t, off_k1 in zip(k_t.As, s_t.As, refused):
        if not off_k1:
            continue
        assert isinstance(a_k, StreamOperator)
        assert a_k.bwd is None and a_k.fwd.transpose is None
        assert a_k.perm is None and a_k.iperm is None
        np.testing.assert_array_equal(a_k.fwd.row_ptr.numpy(),
                                      a_t.row_ptr.numpy())
        np.testing.assert_array_equal(a_k.fwd.cols.numpy(), a_t.cols.numpy())
        np.testing.assert_array_equal(a_k.fwd.vals.numpy(), a_t.vals.numpy())
        np.testing.assert_array_equal(a_k.diagonal().numpy(),
                                      a_t.diagonal().numpy())
        x = torch.from_numpy(vec(a_t.n_rows, 8))
        torch.testing.assert_close(a_k.matvec(x), a_t.matvec(x))
        with pytest.raises(ValueError, match="forward-only"):
            a_k.rmatvec(x)
        y = a_k.matvec(x.clone().requires_grad_())
        with pytest.raises(ValueError, match="gradient unavailable"):
            y.sum().backward()
    assert len(k_t.Ps) == len(s_t.Ps)
    for p_k, p_t in zip(k_t.Ps, s_t.Ps):
        assert isinstance(p_k, RectStreamOperator)
        assert p_k.shape == p_t.shape
        assert p_k.fwd.transpose is p_k.bwd and p_k.bwd.transpose is p_k.fwd
        xc, xf = torch.from_numpy(vec(p_t.n_cols, 9)), torch.from_numpy(
            vec(p_t.n_rows, 10))
        torch.testing.assert_close(p_k.matvec(xc), p_t.matvec(xc))
        torch.testing.assert_close(p_k.rmatvec(xf), p_t.rmatvec(xf))
    x_j, h_j = jax_mg_pcg("sa", case)
    n = s_t.As[0].n_rows
    x_t, h_t = tk.mg_pcg(k_t, torch.from_numpy(vec(n, 6)), torch.zeros(n),
                         n_iters=15, flip_sign=case == "lap32")
    assert_history(h_t, h_j, vec(n, 6))
    assert_close(x_t, x_j)
    # the CPU runs K2's plain version: no launch counted
    assert all(c.launches == 0 for p in k_t.Ps for c in (p.fwd, p.bwd))
    assert all(a.fwd.launches == 0 for a, r in zip(k_t.As, refused) if r)


# -------------------------------------------------------------- Krylov
def assert_history(h_t, h_j, b):
    h_t, h_j = h_t.numpy(), np.asarray(h_j)
    assert h_t.shape == h_j.shape
    live = h_j > 1e-5 * np.linalg.norm(b)
    assert live.sum() >= 3
    np.testing.assert_allclose(h_t[live], h_j[live], rtol=1e-4)


def test_cg_and_amg_pcg_match():
    """The JAX package's own Krylov problem: the 25^2 Laplacian, CG
    without a preconditioner and with the two-grid cycle, both signs."""
    A_j, A_t = j_laplacian_2d(25), t_laplacian_2d(25, device=CPU)
    b = np.random.default_rng(24601).random(625).astype(np.float32)
    bj, bt = jnp.asarray(b), torch.from_numpy(b)
    _, h_j = jk.cg(lambda v: -A_j.matvec(v), -bj, jnp.zeros(625),
                   n_iters=40)
    x_t, h_t = tk.cg(lambda v: -A_t.matvec(v), -bt, torch.zeros(625),
                     n_iters=40)
    assert_history(h_t, h_j, b)
    tg_j = jv.setup_twogrid(A_j, theta=0.25, splitting="cljp", seed=0)
    tg_t = tv.setup_twogrid(A_t, theta=0.25, splitting="cljp", seed=0)
    for flip in (True, False):
        _, h_j = jk.amg_pcg(tg_j, bj, jnp.zeros(625), n_iters=12,
                            flip_sign=flip)
        _, h_t = tk.amg_pcg(tg_t, bt, torch.zeros(625), n_iters=12,
                            flip_sign=flip)
        assert_history(h_t, h_j, b)


@functools.lru_cache(maxsize=None)
def jax_mg_pcg(kind, case):
    """JAX's mg_pcg (x, history) on its hierarchy: 15 iterations on the
    seed-6 right-hand side, with flip_sign on the negative-definite
    Laplacian."""
    s_j, s_t = hierarchies(kind, case)
    n = s_t.As[0].n_rows
    return jk.mg_pcg(s_j, jnp.asarray(vec(n, 6)), jnp.zeros(n), n_iters=15,
                     flip_sign=case == "lap32")


@pytest.mark.parametrize("kind,case", [("sa", "lap32"), ("sa", "fem32"),
                                       ("classical", "lap32")])
def test_mg_pcg_matches(kind, case):
    _, s_t = hierarchies(kind, case)
    n = s_t.As[0].n_rows
    x_j, h_j = jax_mg_pcg(kind, case)
    x_t, h_t = tk.mg_pcg(s_t, torch.from_numpy(vec(n, 6)), torch.zeros(n),
                         n_iters=15, flip_sign=case == "lap32")
    assert_history(h_t, h_j, vec(n, 6))
    assert_close(x_t, x_j)


def test_cg_guards_and_refusals():
    """A zero right-hand side hits both guards (p.Ap = 0, r.z = 0): x
    stays zero, not NaN; mg_pcg refuses a two-grid setup."""
    A = t_laplacian_2d(6, device=CPU)
    x, h = tk.cg(lambda v: -A.matvec(v), torch.zeros(36), torch.zeros(36),
                 n_iters=3)
    assert torch.equal(x, torch.zeros(36)) and torch.equal(h, torch.zeros(3))
    with pytest.raises(TypeError, match="MultigridSetup"):
        tk.mg_pcg(tv.setup_twogrid(A), torch.ones(36), torch.zeros(36),
                  n_iters=2)
