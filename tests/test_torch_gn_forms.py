"""Parity of the port's GN-block forms and fused forms (matvec, residual,
the weighted norm, Jacobi, Chebyshev, the power method, SOC, direct
interpolation) and of `setup_twogrid(use_device_gnn=True)` with the JAX
package on the CPU.

Fixtures: `laplacian_2d(8)`, `laplacian_nd((3, 3), bcs=(1, 1))` and a
seeded random SPD pattern, built from the same scipy matrix in both
packages; the same seeded numpy vectors go through both. Tolerance rtol
1e-5, atol 1e-6; `direct_interp` compares with equal_nan, its non-finite
positions identical. The setup is held to tests/test_amg.py's tolerances
(P rtol 1e-5 / atol 1e-6, Ac rtol 1e-4 / atol 1e-5).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import gnnla_tpu.models as jm
import gnnla_tpu_torch.models as tm
from gnnla_tpu.ops.sparse import SparseOperator as JSparse
from gnnla_tpu.problems import laplacian as jlap
from gnnla_tpu_torch.ops.sparse import SparseOperator as TSparse

jcheb = importlib.import_module("gnnla_tpu.models.chebyshev")
tcheb = importlib.import_module("gnnla_tpu_torch.models.chebyshev")
jv = importlib.import_module("gnnla_tpu.models.vcycle")
tv = importlib.import_module("gnnla_tpu_torch.models.vcycle")

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _random_spd(n=30, seed=5):
    """A seeded random symmetric pattern made strictly diagonally dominant
    (SPD), off-diagonals of both signs."""
    r = sp.random(n, n, density=0.15, random_state=seed, format="csr")
    r.data = r.data - 0.5
    off = r + r.T
    off.setdiag(0)
    off.eliminate_zeros()
    d = np.asarray(abs(off).sum(axis=1)).ravel() + 1.0
    return (off + sp.diags(d)).tocsr()


FIXTURES = {
    "lap2d_8": lambda: jlap.laplacian_2d(8).to_scipy(),
    "lapnd_3x3_periodic": lambda: jlap.laplacian_nd(
        (3, 3), bcs=(1, 1))[0].to_scipy(),
    "random_spd": _random_spd,
}
NAMES = list(FIXTURES)
_CACHE = {}


def pair(name):
    """(JAX operator, port operator on the CPU) of one fixture."""
    if name not in _CACHE:
        m = FIXTURES[name]()
        _CACHE[name] = (JSparse.from_scipy(m),
                        TSparse.from_scipy(m, device=CPU))
    return _CACHE[name]


def vecs(n, k=2, seed=0, cols=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if cols is None else (n, cols)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(k)]


def spd_pair(name):
    """The fixture with a positive diagonal (W of the weighted norm)."""
    opj, opt = pair(name)
    if opj.host_diagonal()[0] < 0:
        return opj.scale(-1.0), opt.scale(-1.0)
    return opj, opt


# ------------------------------------------------------------ SpMV forms
@pytest.mark.parametrize("cols", [None, 3], ids=["vector", "X3"])
@pytest.mark.parametrize("name", NAMES)
def test_matvec(name, cols):
    opj, opt = pair(name)
    (x,) = vecs(opj.n_cols, 1, cols=cols)
    want = jm.matvec_gnn(opj, jnp.asarray(x))
    got = tm.matvec_gnn(opt, _t(x))
    assert tuple(got.shape) == tuple(want.shape)
    close(got, want)
    close(tm.matvec(opt, _t(x)), jm.matvec(opj, jnp.asarray(x)))
    close(got, tm.matvec(opt, _t(x)))


@pytest.mark.parametrize("name", NAMES)
def test_residual(name):
    opj, opt = pair(name)
    b, x = vecs(opj.n_rows, seed=1)
    want = jm.residual_gnn(opj, jnp.asarray(b), jnp.asarray(x))
    close(tm.residual_gnn(opt, _t(b), _t(x)), want)
    close(tm.residual(opt, _t(b), _t(x)),
          jm.residual(opj, jnp.asarray(b), jnp.asarray(x)))


@pytest.mark.parametrize("name", NAMES)
def test_weighted_norm(name):
    opj, opt = spd_pair(name)
    (x,) = vecs(opj.n_rows, 1, seed=2)
    got = tm.matrix_weighted_norm_gnn(opt, _t(x))
    want = jm.matrix_weighted_norm_gnn(opj, jnp.asarray(x))
    assert got.ndim == np.ndim(want) == 0
    close(got, want)
    close(tm.matrix_weighted_norm(opt, _t(x)),
          jm.matrix_weighted_norm(opj, jnp.asarray(x)))
    assert np.isfinite(float(got))


def test_weighted_norm_is_nan_on_an_indefinite_matrix():
    opj, opt = pair("lap2d_8")  # negative definite: sqrt of a negative
    (x,) = vecs(opj.n_rows, 1, seed=3)
    assert np.isnan(float(tm.matrix_weighted_norm_gnn(opt, _t(x))))
    assert np.isnan(float(jm.matrix_weighted_norm_gnn(opj, jnp.asarray(x))))


@pytest.mark.parametrize("wrt", ["x", "vals"])
@pytest.mark.parametrize("name", NAMES)
def test_weighted_norm_gradient(name, wrt):
    """autograd through the GN form against jax.grad, in x and in the
    operator's values."""
    opj, opt = spd_pair(name)
    (x,) = vecs(opj.n_rows, 1, seed=4)
    if wrt == "x":
        want = jax.grad(lambda xx: jm.matrix_weighted_norm_gnn(opj, xx))(
            jnp.asarray(x))
        xt = _t(x).clone().requires_grad_(True)
        tm.matrix_weighted_norm_gnn(opt, xt).backward()
        got = xt.grad
    else:
        want = jax.grad(lambda v: jm.matrix_weighted_norm_gnn(
            opj.with_values(v), jnp.asarray(x)))(opj.vals)
        vals = opt.vals.detach().clone().requires_grad_(True)
        tm.matrix_weighted_norm_gnn(opt.with_values(vals), _t(x)).backward()
        got = vals.grad
    close(got, want, 1e-5, 1e-5)


# --------------------------------------------------------- relaxations
@pytest.mark.parametrize("name", NAMES)
def test_jacobi(name):
    opj, opt = pair(name)
    b, x = vecs(opj.n_rows, seed=5)
    kw = dict(omega=0.7, n_iters=3)
    want = jm.jacobi_gnn(opj, jnp.asarray(b), jnp.asarray(x), **kw)
    got = tm.jacobi_gnn(opt, _t(b), _t(x), **kw)
    close(got, want)
    close(tm.jacobi(opt, _t(b), _t(x), **kw),
          jm.jacobi(opj, jnp.asarray(b), jnp.asarray(x), **kw))
    close(got, tm.jacobi(opt, _t(b), _t(x), **kw))


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("name", NAMES)
def test_chebyshev(name, deg):
    opj, opt = pair(name)
    b, x = vecs(opj.n_rows, seed=6)
    kw = dict(c=-3.4, d=-4.0, deg=deg)
    want = jm.chebyshev_gnn(opj, jnp.asarray(b), jnp.asarray(x), **kw)
    got = tm.chebyshev_gnn(opt, _t(b), _t(x), **kw)
    close(got, want)
    close(tm.chebyshev(opt, _t(b), _t(x), **kw),
          jm.chebyshev(opj, jnp.asarray(b), jnp.asarray(x), **kw))
    # two blocks per iteration, as the JAX layer list
    assert len(tcheb._build_layers(deg)) == len(jcheb._build_layers(deg)) \
        == 2 * deg


@pytest.mark.parametrize("name", NAMES)
def test_power_method(name):
    opj, opt = pair(name)
    (b0,) = vecs(opj.n_rows, 1, seed=7)
    lam_j, b_j = jm.power_method_gnn(opj, jnp.asarray(b0), n_iters=10)
    lam_t, b_t = tm.power_method_gnn(opt, _t(b0), n_iters=10)
    close(lam_t, lam_j)
    close(b_t, b_j)
    lam_f, b_f = tm.power_method(opt, _t(b0), n_iters=10)
    lam_jf, b_jf = jm.power_method(opj, jnp.asarray(b0), n_iters=10)
    close(lam_f, lam_jf)
    close(b_f, b_jf)
    close(lam_t, lam_f)


# ------------------------------------------------------------- AMG forms
@pytest.mark.parametrize("name", NAMES)
def test_soc_classic(name):
    opj, opt = pair(name)
    nd_j, nd_t = opj.remove_diagonal(), opt.remove_diagonal()
    want = np.asarray(jm.soc_classic(nd_j, 0.25))
    got = tm.soc_classic(nd_t, 0.25).numpy()
    close(got, want)
    np.testing.assert_array_equal(got > 0, want > 0)
    # the host formula of the setup gives the same strong connections
    rows, cols, vals = nd_t.host_coo()
    np.testing.assert_array_equal(
        got > 0, tv._soc_classic_host(rows, cols, vals, opt.n_rows, 0.25))


@pytest.mark.parametrize("name", NAMES)
def test_soc_sa(name):
    opj, opt = pair(name)
    nd_j, nd_t = opj.remove_diagonal(), opt.remove_diagonal()
    want = jm.soc_sa(nd_j, opj.diagonal())
    close(tm.soc_sa(nd_t, opt.diagonal()), want)


@pytest.mark.parametrize("name", NAMES)
def test_direct_interp(name):
    """The weights of the two-block GNN, inf/NaN included where a row has
    no strong coarse neighbour (not repaired: the prolongation decides
    what it reads)."""
    opj, opt = pair(name)
    nd_j, nd_t = opj.remove_diagonal(), opt.remove_diagonal()
    strong = np.asarray(jm.soc_classic(nd_j, 0.25)) > 0
    coarse = (np.random.default_rng(8).random(opj.n_rows) < 0.4)
    # vertex 0 and its neighbours fine: row 0 has no strong C neighbour
    rows, cols, _ = nd_t.host_coo()
    coarse[0] = False
    coarse[cols[rows == 0]] = False
    args_j = (jnp.asarray(coarse, jnp.float32),
              jnp.asarray(strong, jnp.float32))
    want = np.asarray(jm.direct_interp(nd_j, opj.diagonal(), *args_j))
    got = tm.direct_interp(nd_t, opt.diagonal(), _t(coarse.astype(
        np.float32)), _t(strong.astype(np.float32))).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert not np.isfinite(want[rows == 0]).any()  # the x/0 case
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               equal_nan=True)


# ------------------------------------------------ the device-GNN setup
_SETUPS = {}


def _setups(n):
    """(JAX device-GNN, port device-GNN, port host) setups of the n^2
    Laplacian, as tests/test_amg.py builds them."""
    if n not in _SETUPS:
        kw = dict(theta=0.25, splitting="cljp", seed=0)
        A_t = TSparse.from_scipy(jlap.laplacian_2d(n).to_scipy(),
                                 device=CPU)
        _SETUPS[n] = (jv.setup_twogrid(jlap.laplacian_2d(n),
                                       use_device_gnn=True, **kw),
                      tv.setup_twogrid(A_t, use_device_gnn=True, **kw),
                      tv.setup_twogrid(A_t, **kw))
    return _SETUPS[n]


@pytest.mark.parametrize("against", ["jax_device_gnn", "port_host"])
@pytest.mark.parametrize("n", [8, 32])
def test_setup_twogrid_device_gnn(n, against):
    s_j, s_dev, s_host = _setups(n)
    want = s_j if against == "jax_device_gnn" else s_host
    np.testing.assert_array_equal(s_dev.coarse_flags.numpy(),
                                  np.asarray(want.coarse_flags))
    assert s_dev.P.shape == want.P.shape and s_dev.Ac.shape == want.Ac.shape
    close(s_dev.P.to_dense(), want.P.to_dense(), 1e-5, 1e-6)
    close(s_dev.Ac.to_dense(), want.Ac.to_dense(), 1e-4, 1e-5)
    np.testing.assert_array_equal(s_dev.diag.numpy(), np.asarray(s_j.diag))
    assert s_dev.P.device.type == "cpu"
