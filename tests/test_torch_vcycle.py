"""Parity of the PyTorch port's two-grid V-cycle (gnnla_tpu_torch.models)
with the JAX package on the CPU.

The fast configuration is held against the JAX fast configuration
(`setup_with_dia(pallas=True)` in Pallas interpret mode + `setup_with_stream_p`
on the stream emulator) within the JAX package's own fast-path tolerance:
rtol 2e-5, atol 2e-5 * max|want| (tests/test_vcycle_fast.py).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnla_tpu.ops.sparse import SparseOperator as JSparse
from gnnla_tpu.problems import laplacian_2d as j_laplacian_2d
from gnnla_tpu_torch.models.chebyshev import chebyshev as t_chebyshev
from gnnla_tpu_torch.models.jacobi import jacobi as t_jacobi
from gnnla_tpu_torch.models.residual import residual as t_residual
from gnnla_tpu_torch.ops.dia_spmv import DiaKernelOperator
from gnnla_tpu_torch.ops.sparse import SparseOperator as TSparse
from gnnla_tpu_torch.ops.stream_op import RectStreamOperator
from gnnla_tpu_torch.problems import laplacian_2d as t_laplacian_2d

jv = importlib.import_module("gnnla_tpu.models.vcycle")
tv = importlib.import_module("gnnla_tpu_torch.models.vcycle")

CPU = "cpu"
N_CYCLES = 4


def assert_close(got, want, rtol, atol_scale):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * np.abs(want).max())


def _interpret(monkeypatch):
    from jax.experimental import pallas as pl

    real = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return real(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _rhs(n_rows, seed=0):
    return np.random.default_rng(seed).standard_normal(n_rows).astype(
        np.float32)


_CACHE = {}


def _pair(n):
    """(jax setup, port setup) of the n^2 Laplacian, built once."""
    if n not in _CACHE:
        A_j = j_laplacian_2d(n).eliminate_zeros()
        A_t = t_laplacian_2d(n, device=CPU).eliminate_zeros()
        _CACHE[n] = (jv.setup_twogrid(A_j, theta=0.25, splitting="cljp",
                                      seed=0),
                     tv.setup_twogrid(A_t, theta=0.25, splitting="cljp",
                                      seed=0))
    return _CACHE[n]


def _jax_fast_solution(n, monkeypatch):
    """The JAX fast configuration's 4-cycle solution, computed once."""
    key = ("fast", n)
    if key not in _CACHE:
        _interpret(monkeypatch)
        s_j, _ = _pair(n)
        fast = jv.setup_with_stream_p(jv.setup_with_dia(s_j, pallas=True),
                                      backend="emulate")
        from gnnla_tpu.ops.pallas_spmv import PallasDiaOperator
        from gnnla_tpu.ops.stream_op import RectStreamOperator as JRect
        assert isinstance(fast.A, PallasDiaOperator)
        assert isinstance(fast.Ac, PallasDiaOperator)
        assert isinstance(fast.P, JRect)
        b = _rhs(s_j.A.n_rows)
        _CACHE[key] = np.asarray(jv.solve(fast, jnp.asarray(b),
                                          jnp.zeros(b.shape[0]),
                                          n_cycles=N_CYCLES))
    return _CACHE[key]


def _port_fast(setup):
    fast = tv.setup_with_stream_p(tv.setup_with_dia(setup, kernel=True))
    assert isinstance(fast.A, DiaKernelOperator)
    assert isinstance(fast.Ac, DiaKernelOperator)
    assert isinstance(fast.P, RectStreamOperator)
    return fast


def _port_solve(setup, n_cycles=N_CYCLES):
    b = _rhs(setup.A.n_rows)
    return tv.solve(setup, torch.from_numpy(b), torch.zeros(b.shape[0]),
                    n_cycles=n_cycles).numpy()


# ------------------------------------------------------------------ setup
@pytest.mark.parametrize("n", [24, 40])
def test_setup_twogrid_matches(n):
    s_j, s_t = _pair(n)
    np.testing.assert_array_equal(s_t.coarse_flags.numpy(),
                                  np.asarray(s_j.coarse_flags))
    np.testing.assert_array_equal(s_t.diag.numpy(), np.asarray(s_j.diag))
    for name in ("P", "Ac"):
        t, j = getattr(s_t, name), getattr(s_j, name)
        assert t.shape == j.shape
        (tr, tc, tvals), (jr, jc, jvals) = t.host_coo(), j.host_coo()
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_allclose(tvals, jvals, rtol=1e-6)
        np.testing.assert_allclose(t.vals.numpy(), np.asarray(j.vals),
                                   rtol=1e-6)


@pytest.mark.parametrize("splitting", ["cljp", "pmis", "alternating"])
@pytest.mark.parametrize("interp", ["reference", "signed"])
def test_setup_options_match(splitting, interp):
    A_j = j_laplacian_2d(16).eliminate_zeros()
    A_t = t_laplacian_2d(16, device=CPU).eliminate_zeros()
    kw = dict(theta=0.25, splitting=splitting, seed=3, interp=interp,
              trunc=0.2)
    s_j, s_t = jv.setup_twogrid(A_j, **kw), tv.setup_twogrid(A_t, **kw)
    np.testing.assert_array_equal(s_t.coarse_flags.numpy(),
                                  np.asarray(s_j.coarse_flags))
    for a, b in zip(s_t.P.host_coo(), s_j.P.host_coo()):
        np.testing.assert_allclose(a, b, rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numpy_splittings_match(seed):
    """The numpy CLJP (the fallback without the native library) and PMIS
    give the JAX package's flags."""
    from gnnla_tpu.amg import splitting as j_split
    from gnnla_tpu_torch.amg import splitting as t_split

    A = j_laplacian_2d(20).eliminate_zeros().remove_diagonal()
    rows, cols, vals = A.host_coo()
    strong = jv._soc_classic_host(rows, cols, vals, A.n_rows, 0.25)
    import scipy.sparse as sp
    S = sp.coo_matrix((strong.astype(float), (rows, cols)),
                      shape=A.shape).tocsr()
    for fn in ("split_cljp", "split_pmis"):
        np.testing.assert_array_equal(getattr(t_split, fn)(S, seed=seed),
                                      getattr(j_split, fn)(S, seed=seed))


def test_use_device_gnn_matches_host():
    """SOC and direct interpolation through the GN-block forms give the
    host setup (tests/test_amg.py's tolerances)."""
    _, s_t = _pair(24)
    s_d = tv.setup_twogrid(s_t.A, theta=0.25, splitting="cljp", seed=0,
                           use_device_gnn=True)
    np.testing.assert_array_equal(s_d.coarse_flags.numpy(),
                                  s_t.coarse_flags.numpy())
    np.testing.assert_allclose(s_d.P.to_dense().numpy(),
                               s_t.P.to_dense().numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(s_d.Ac.to_dense().numpy(),
                               s_t.Ac.to_dense().numpy(), rtol=1e-4,
                               atol=1e-5)


# ------------------------------------------------------- fused GN kernels
@pytest.mark.parametrize("deg", [0, 1, 2, 3, 5])
def test_chebyshev_matches(deg):
    from gnnla_tpu.models.chebyshev import chebyshev as j_chebyshev

    s_j, s_t = _pair(24)
    b = _rhs(s_j.Ac.n_rows, 4)
    x = _rhs(s_j.Ac.n_rows, 5)
    got = t_chebyshev(s_t.Ac, torch.from_numpy(b), torch.from_numpy(x),
                      c=-3.4, d=-4.0, deg=deg)
    want = j_chebyshev(s_j.Ac, jnp.asarray(b), jnp.asarray(x), c=-3.4,
                       d=-4.0, deg=deg)
    assert_close(got, want, 1e-5, 1e-6)


@pytest.mark.parametrize("override", [False, True])
def test_jacobi_and_residual_match(override):
    from gnnla_tpu.models.jacobi import jacobi as j_jacobi
    from gnnla_tpu.models.residual import residual as j_residual

    s_j, s_t = _pair(24)
    b, x = _rhs(s_j.A.n_rows, 6), _rhs(s_j.A.n_rows, 7)
    d = (np.linspace(-5.0, -3.0, s_j.A.n_rows).astype(np.float32)
         if override else None)
    got = t_jacobi(s_t.A, torch.from_numpy(b), torch.from_numpy(x),
                   omega=0.7, n_iters=3,
                   diag=None if d is None else torch.from_numpy(d))
    want = j_jacobi(s_j.A, jnp.asarray(b), jnp.asarray(x), omega=0.7,
                    n_iters=3, diag=None if d is None else jnp.asarray(d))
    assert_close(got, want, 1e-5, 1e-6)
    assert_close(t_residual(s_t.A, torch.from_numpy(b), torch.from_numpy(x)),
                 j_residual(s_j.A, jnp.asarray(b), jnp.asarray(x)),
                 1e-5, 1e-6)


# ------------------------------------------------------------------ cycles
def test_coo_solve_matches():
    s_j, s_t = _pair(24)
    b = _rhs(s_j.A.n_rows)
    want = np.asarray(jv.solve(s_j, jnp.asarray(b), jnp.zeros(b.shape[0]),
                               n_cycles=N_CYCLES))
    assert_close(_port_solve(s_t), want, 2e-5, 2e-5)


@pytest.mark.parametrize("n", [24, 40])
def test_fast_solve_matches_jax_fast(n, monkeypatch):
    want = _jax_fast_solution(n, monkeypatch)
    _, s_t = _pair(n)
    got = _port_solve(_port_fast(s_t))
    assert_close(got, want, 2e-5, 2e-5)
    # the cycle converges: residual of the 4-cycle iterate below b's
    r = _rhs(s_t.A.n_rows) - s_t.A.matvec(torch.from_numpy(got)).numpy()
    assert np.linalg.norm(r) < 0.5 * np.linalg.norm(_rhs(s_t.A.n_rows))


def _export(s_j):
    """A JAX TwoGridSetup as plain numpy arrays (setup_from_numpy keys)."""
    d = {"diag": np.asarray(s_j.diag),
         "coarse_flags": np.asarray(s_j.coarse_flags)}
    for name in ("A", "P", "Ac"):
        op = getattr(s_j, name)
        d[f"{name}_rows"], d[f"{name}_cols"], d[f"{name}_vals"] = \
            op.host_coo()
        d[f"{name}_shape"] = np.asarray(op.shape)
    return d


@pytest.mark.parametrize("n", [24, 40])
def test_setup_from_numpy_runs_the_same_cycle(n, monkeypatch):
    want = _jax_fast_solution(n, monkeypatch)
    s_j, _ = _pair(n)
    s_t = tv.setup_from_numpy(_export(s_j), device=CPU)
    np.testing.assert_array_equal(s_t.coarse_flags.numpy(),
                                  np.asarray(s_j.coarse_flags))
    assert_close(_port_solve(_port_fast(s_t)), want, 2e-5, 2e-5)


def test_setup_from_numpy_carries_a_trained_diagonal():
    """`diag` is the Jacobi override: a scaled diagonal changes the cycle
    exactly as it does in the JAX package."""
    s_j, _ = _pair(24)
    d = _export(s_j)
    d["diag"] = (np.asarray(s_j.diag) * 1.25).astype(np.float32)
    s_t = tv.setup_from_numpy(d, device=CPU)
    import dataclasses
    s_j2 = dataclasses.replace(s_j, diag=jnp.asarray(d["diag"]))
    b = _rhs(s_j.A.n_rows)
    want = np.asarray(jv.solve(s_j2, jnp.asarray(b), jnp.zeros(b.shape[0]),
                               n_cycles=2))
    assert_close(_port_solve(s_t, n_cycles=2), want, 2e-5, 2e-5)


# ------------------------------------------------- layout choice of P
def _empty_p_setups():
    """A setup whose P has no nonzeros: the JAX packer refuses it."""
    s_j, _ = _pair(24)
    d = _export(s_j)
    empty = np.zeros(0, np.int64)
    d["P_rows"], d["P_cols"], d["P_vals"] = empty, empty, empty
    import dataclasses
    P_j = JSparse.from_coo(empty, empty, empty, tuple(d["P_shape"]))
    return (dataclasses.replace(s_j, P=P_j),
            tv.setup_from_numpy(d, device=CPU))


@pytest.mark.parametrize("case", ["lap24", "lap40", "lap64", "empty_P"])
def test_setup_with_stream_p_keeps_coo_exactly_when_jax_does(case):
    from gnnla_tpu.ops.stream_op import RectStreamOperator as JRect

    if case == "empty_P":
        s_j, s_t = _empty_p_setups()
    else:
        s_j, s_t = _pair(int(case[3:]))
    swapped_j = isinstance(
        jv.setup_with_stream_p(s_j, backend="emulate").P, JRect)
    P_t = tv.setup_with_stream_p(s_t).P
    swapped_t = isinstance(P_t, RectStreamOperator)
    assert swapped_t == swapped_j
    assert swapped_t == (case != "empty_P")
    if not swapped_t:
        assert P_t is s_t.P and isinstance(P_t, TSparse)
    # idempotent: a swapped setup is returned as it is
    again = tv.setup_with_stream_p(tv.setup_with_stream_p(s_t))
    assert type(again.P) is type(P_t)
