"""Parity of the port's grid cycles — `GeometricVCycle` (models/geometric.py)
and `StencilVCycle` (models/vcycle.py) — with the JAX package on the CPU.

The JAX package builds each setup (an alternating setup for the geometric
cycle, a CLJP setup for the stencil cycle); its COO triplets are carried
across with `setup_from_numpy`, so both packages run the same operators.
The JAX side runs kernel K4 in Pallas interpret mode, the port K4's plain
version on CPU tensors.

Tolerance for 2-cycle solves: rtol 1e-4, atol 1e-5 * max|x| — the JAX
package's own tolerance for these cycles (tests/test_pallas.py): the two
sides sum the restriction, prolongation and coarse solve in different
orders in f32.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnla_tpu.models.geometric import GeometricVCycle as JGeometric
from gnnla_tpu.ops.sparse import SparseOperator as JSparse
from gnnla_tpu.problems import laplacian_2d as j_laplacian_2d
from gnnla_tpu.problems import stretched_mesh_matrix
from gnnla_tpu_torch.models.geometric import GeometricVCycle, _interp_planes
from gnnla_tpu_torch.ops.dia import DIAOperator

jv = importlib.import_module("gnnla_tpu.models.vcycle")
tv = importlib.import_module("gnnla_tpu_torch.models.vcycle")

RTOL, ATOL_SCALE = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    real = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return real(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


def assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_SCALE * np.abs(want).max())


def nonsymmetric_5pt(n, seed=0):
    """Random values on the 5-point pattern: diagonal -4, off-diagonals
    uniform in [0.5, 1.5] (A != A^T)."""
    A = j_laplacian_2d(n).eliminate_zeros()
    rows, cols, vals = A.host_coo()
    rng = np.random.default_rng(seed)
    v = np.where(rows == cols, -4.0, rng.uniform(0.5, 1.5, rows.size))
    return JSparse.from_coo(rows, cols, v, A.shape)


def grid_operator(case):
    if case == "lap16":
        return j_laplacian_2d(16).eliminate_zeros(), (16, 16)
    if case == "fem12":
        return stretched_mesh_matrix(13, stretch=3.0), (12, 12)
    if case == "nonsym16":
        return nonsymmetric_5pt(16), (16, 16)
    raise KeyError(case)


def export(s_j):
    """A JAX TwoGridSetup as plain numpy arrays (setup_from_numpy keys)."""
    d = {"diag": np.asarray(s_j.diag),
         "coarse_flags": np.asarray(s_j.coarse_flags)}
    for name in ("A", "P", "Ac"):
        op = getattr(s_j, name)
        d[f"{name}_rows"], d[f"{name}_cols"], d[f"{name}_vals"] = \
            op.host_coo()
        d[f"{name}_shape"] = np.asarray(op.shape)
    return d


def rhs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def run_cycles(cycle, b, n_cycles, to, zeros):
    x = zeros(b.shape[0])
    for _ in range(n_cycles):
        x = cycle(to(b), x)
    return np.asarray(x)


# ----------------------------------------------------------- GeometricVCycle
# (case, cycle kwargs, diagonal scale: 1 = the operator's, else trained)
GEOMETRIC = [("lap16", dict(n_pre=2, n_post=3), 1.0),
             ("fem12", {}, 1.0),
             ("nonsym16", {}, 1.0),
             ("lap16", {}, 1.25)]


@pytest.mark.parametrize("case,kw,dscale", GEOMETRIC,
                         ids=["lap16-pre2-post3", "fem12", "nonsym16",
                              "lap16-trained-diag"])
def test_geometric_matches_jax(case, kw, dscale):
    """The port's GeometricVCycle on a setup carried across from the JAX
    package matches JAX's GeometricVCycle and JAX's generic vcycle on the
    same alternating setup, over 2 cycles."""
    A_j, gs = grid_operator(case)
    s_j = jv.setup_twogrid(A_j, splitting="alternating")
    if dscale != 1.0:
        s_j = dataclasses.replace(
            s_j, diag=jnp.asarray(np.asarray(s_j.diag) * dscale, jnp.float32))
    s_t = tv.setup_from_numpy(export(s_j), device="cpu")
    g_j = JGeometric(A_j, gs, setup=s_j, **kw)
    g_t = GeometricVCycle(s_t.A, gs, setup=s_t, **kw)
    assert g_t._p_offsets == g_j._p_offsets
    b = rhs(A_j.n_rows)
    got = run_cycles(g_t.run, b, 2, torch.from_numpy, torch.zeros)
    want_geo = run_cycles(g_j.run, b, 2, jnp.asarray, jnp.zeros)
    want_generic = run_cycles(lambda bb, xx: jv.vcycle(s_j, bb, xx, **kw),
                              b, 2, jnp.asarray, jnp.zeros)
    assert_close(got, want_geo)
    assert_close(got, want_generic)


def test_geometric_builds_its_own_setup_like_jax():
    """Without `setup=`, both packages build the alternating setup from A
    and give the same cycle."""
    A_j, gs = grid_operator("lap16")
    s_t = tv.setup_from_numpy(export(jv.setup_twogrid(A_j)), device="cpu")
    g_j = JGeometric(A_j, gs)
    g_t = GeometricVCycle(s_t.A, gs)
    np.testing.assert_array_equal(g_t.setup.coarse_flags.numpy(),
                                  np.asarray(g_j.setup.coarse_flags))
    b = rhs(A_j.n_rows, 1)
    assert_close(run_cycles(g_t.run, b, 2, torch.from_numpy, torch.zeros),
                 run_cycles(g_j.run, b, 2, jnp.asarray, jnp.zeros))


def test_interp_planes_identical():
    from gnnla_tpu.models.geometric import _interp_planes as j_interp

    A_j, gs = grid_operator("fem12")
    s_j = jv.setup_twogrid(A_j, splitting="alternating")
    s_t = tv.setup_from_numpy(export(s_j), device="cpu")
    off_j, p_j = j_interp(s_j.P, gs)
    off_t, p_t = _interp_planes(s_t.P, gs)
    assert off_t == off_j
    np.testing.assert_array_equal(p_t, p_j)


def test_geometric_residual_falls_every_cycle():
    from gnnla_tpu_torch.problems import laplacian_2d

    A = laplacian_2d(32, device="cpu")
    g = GeometricVCycle(A, (32, 32))
    b = torch.from_numpy(rhs(A.n_rows, 2))
    x = torch.zeros_like(b)
    res = [float(torch.linalg.vector_norm(b - A.matvec(x)))]
    for _ in range(4):
        x = g.run(b, x)
        res.append(float(torch.linalg.vector_norm(b - A.matvec(x))))
    assert all(r1 < r0 for r0, r1 in zip(res, res[1:])), res


def test_geometric_refusals_match_jax():
    from gnnla_tpu_torch.problems import laplacian_2d

    with pytest.raises(ValueError, match="even"):
        JGeometric(j_laplacian_2d(9), (9, 9))
    with pytest.raises(ValueError, match="even"):
        GeometricVCycle(laplacian_2d(9, device="cpu"), (9, 9))
    A_j, gs = grid_operator("lap16")
    s_j = jv.setup_twogrid(A_j, splitting="cljp")
    s_t = tv.setup_from_numpy(export(s_j), device="cpu")
    with pytest.raises(ValueError, match="alternating"):
        JGeometric(A_j, gs, setup=s_j)
    with pytest.raises(ValueError, match="alternating"):
        GeometricVCycle(s_t.A, gs, setup=s_t)
    s_alt = tv.setup_from_numpy(
        export(jv.setup_twogrid(A_j, splitting="alternating")), device="cpu")
    with pytest.raises(ValueError, match="COO TwoGridSetup"):
        GeometricVCycle(s_alt.A, gs, setup=tv.setup_with_dia(s_alt))


def test_geometric_launch_counters_stay_zero_on_cpu():
    A_j, gs = grid_operator("lap16")
    s_t = tv.setup_from_numpy(
        export(jv.setup_twogrid(A_j, splitting="alternating")), device="cpu")
    g = GeometricVCycle(s_t.A, gs, setup=s_t)
    assert len(g.kernel_calls()) == 3  # pre is post (n_pre == n_post)
    g.run(torch.ones(A_j.n_rows), torch.zeros(A_j.n_rows))
    assert all(c.launches == 0 for c in g.kernel_calls())


# ------------------------------------------------------------ StencilVCycle
@pytest.mark.parametrize("case", ["lap16", "fem12", "nonsym16"])
def test_stencil_vcycle_matches_jax(case):
    """StencilVCycle on the CLJP setup (Ac swapped to plain DIA) matches
    JAX's StencilVCycle and the generic vcycle over 2 cycles."""
    A_j, gs = grid_operator(case)
    s_j = jv.setup_twogrid(A_j, splitting="cljp", seed=0)
    s_t = tv.setup_from_numpy(export(s_j), device="cpu")
    kw = dict(n_pre=2, n_post=3, omega=0.7)
    sv_j = jv.make_stencil_vcycle(s_j, gs, **kw)
    sv_t = tv.make_stencil_vcycle(s_t, gs, **kw)
    assert isinstance(sv_t.setup.Ac, DIAOperator)
    assert sv_t.setup.Ac.offsets == sv_j.setup.Ac.offsets
    b = rhs(A_j.n_rows, 3)
    got = run_cycles(sv_t.run, b, 2, torch.from_numpy, torch.zeros)
    assert_close(got, run_cycles(sv_j.run, b, 2, jnp.asarray, jnp.zeros))
    assert_close(got, run_cycles(lambda bb, xx: jv.vcycle(s_j, bb, xx, **kw),
                                 b, 2, jnp.asarray, jnp.zeros))


def test_stencil_vcycle_keeps_coo_ac_without_coarse_dia():
    A_j, gs = grid_operator("lap16")
    s_j = jv.setup_twogrid(A_j)
    s_t = tv.setup_from_numpy(export(s_j), device="cpu")
    sv_t = tv.StencilVCycle(s_t, gs, coarse_dia=False)
    assert sv_t.setup.Ac is s_t.Ac
    b = rhs(A_j.n_rows, 4)
    got = run_cycles(sv_t.run, b, 2, torch.from_numpy, torch.zeros)
    want = run_cycles(lambda bb, xx: jv.vcycle(s_j, bb, xx), b, 2,
                      jnp.asarray, jnp.zeros)
    assert_close(got, want)


def test_stencil_vcycle_refusals_match_jax():
    A_j, gs = grid_operator("lap16")
    s_j = jv.setup_twogrid(A_j)
    s_t = tv.setup_from_numpy(export(s_j), device="cpu")
    with pytest.raises(ValueError, match="COO setup"):
        jv.make_stencil_vcycle(jv.setup_with_dia(s_j), gs)
    with pytest.raises(ValueError, match="COO setup"):
        tv.make_stencil_vcycle(tv.setup_with_dia(s_t), gs)
    with pytest.raises(ValueError, match="n_pre"):
        tv.make_stencil_vcycle(s_t, gs, n_pre=0)
