"""Parity of the port's grid-stencil layout and kernel K4's users
(gnnla_tpu_torch.ops.stencil, .stencil_kernel) with the JAX package
(gnnla_tpu.ops.pallas_stencil) on the CPU.

The same operators go through both packages: the JAX package builds them
and its COO triplets are carried across. The JAX side runs K4 in Pallas
interpret mode; the port runs K4's plain version, which its wrappers take
for CPU tensors.

Every user is tested on four operators: the 5-point Laplacian, a
non-symmetric operator on the same pattern (random values: a wrong shift
sign shows there, not on the symmetric Laplacian), the periodic 9-class
diffusion FEM (the wrap joins the interior classes) and the stretched
9-point FEM.

Tolerance for single kernel calls: rtol 1e-5, atol 1e-5 * max|y|. Both
sides sum in f32 in the same order (tap_0 * v_0 first, then the taps in
shift order); only the rounding of the widened f32 products and, in
normalize mode, of the norm's summation order can differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnla_tpu.ops import pallas_stencil as jps
from gnnla_tpu.ops.sparse import SparseOperator as JSparse
from gnnla_tpu.problems import laplacian_2d as j_laplacian_2d
from gnnla_tpu.problems import stretched_mesh_matrix
from gnnla_tpu.problems.diffusion_fem import constant_diffusion_matrix
from gnnla_tpu_torch.ops import stencil as ts
from gnnla_tpu_torch.ops import stencil_kernel as tk
from gnnla_tpu_torch.ops.sparse import SparseOperator as TSparse

RTOL = 1e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    real = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return real(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


def assert_close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def nonsymmetric_5pt(n, seed=0):
    """Random values on the 5-point pattern of an n x n grid: diagonal -4,
    off-diagonals uniform in [0.5, 1.5], so A != A^T."""
    A = j_laplacian_2d(n).eliminate_zeros()
    rows, cols, vals = A.host_coo()
    rng = np.random.default_rng(seed)
    v = np.where(rows == cols, -4.0, rng.uniform(0.5, 1.5, rows.size))
    return JSparse.from_coo(rows, cols, v, A.shape)


def grid_operator(case):
    """(jax op, grid shape) of a test operator."""
    if case == "lap20":
        return j_laplacian_2d(20).eliminate_zeros(), (20, 20)
    if case == "nonsym20":
        return nonsymmetric_5pt(20), (20, 20)
    if case == "periodic8":
        return constant_diffusion_matrix(1.3, 0.7, 8), (8, 8)
    if case == "fem12":
        A = stretched_mesh_matrix(13, stretch=3.0)
        return A, (12, 12)
    raise KeyError(case)


def carry(op_j):
    """The port's SparseOperator with the JAX operator's COO triplets."""
    rows, cols, vals = op_j.host_coo()
    return TSparse.from_coo(rows, cols, vals, op_j.shape, device="cpu")


def vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


CASES = ["lap20", "nonsym20", "periodic8", "fem12"]


# ------------------------------------------------------------------ layout
@pytest.mark.parametrize("case", CASES)
def test_stencil_taps_identical(case):
    A_j, gs = grid_operator(case)
    A_t = carry(A_j)
    s_j, p_j = jps.stencil_taps(A_j, gs)
    s_t, p_t = ts.stencil_taps(A_t, gs)
    assert s_t == s_j
    assert p_t.dtype == np.float64
    np.testing.assert_array_equal(p_t, p_j)
    rows, cols, _ = A_j.host_coo()
    k_j = jps.stencil_classes(rows, cols, *gs)[1]
    k_t = ts.stencil_classes(rows, cols, *gs)[1]
    np.testing.assert_array_equal(k_t, k_j)


def test_class_counts():
    """5 planes for the 5-point pattern, 9 for the periodic FEM (its wraps
    join the interior classes), 9 for the 9-point FEM."""
    for case, k in (("lap20", 5), ("periodic8", 9), ("fem12", 9)):
        A_j, gs = grid_operator(case)
        assert len(ts.stencil_taps(carry(A_j), gs)[0]) == k


def test_too_many_classes_refused_by_both():
    n = 32 * 32
    rng = np.random.default_rng(0)
    rows = np.arange(n)
    cols = rng.permutation(n)
    vals = np.ones(n)
    A_j = JSparse.from_coo(rows, cols, vals, (n, n))
    with pytest.raises(ValueError, match="shift classes"):
        jps.stencil_taps(A_j, (32, 32))
    with pytest.raises(ValueError, match="shift classes"):
        ts.stencil_taps(carry(A_j), (32, 32))
    assert ts.MAX_TAPS == jps.MAX_TAPS


def test_taps_need_a_square_grid_operator():
    A_j, _ = grid_operator("lap20")
    with pytest.raises(ValueError, match="grid"):
        ts.stencil_taps(carry(A_j), (20, 21))


# ------------------------------------------------------- K4 and its users
@pytest.mark.parametrize("n_steps", [1, 2, 3])
@pytest.mark.parametrize("case", CASES)
def test_spmv_matches(case, n_steps):
    A_j, gs = grid_operator(case)
    s_j = jps.make_stencil_spmv(A_j, gs, n_steps)
    s_t = tk.make_stencil_spmv(carry(A_j), gs, n_steps)
    assert s_t.shifts == s_j.shifts
    np.testing.assert_array_equal(s_t.taps.numpy(), np.asarray(s_j.taps))
    x = vec(A_j.n_rows, 1)
    assert_close(s_t.matvec_n(torch.from_numpy(x)),
                 s_j.matvec_n(jnp.asarray(x)))
    assert s_t._call.launches == 0  # the CPU path runs the plain version


@pytest.mark.parametrize("trained", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_jacobi_matches(case, trained):
    A_j, gs = grid_operator(case)
    n = A_j.n_rows
    d = None
    if trained:  # a trained diagonal: the operator's, rescaled per point
        d = (np.asarray(A_j.diagonal()) *
             np.linspace(0.8, 1.25, n)).astype(np.float32)
    j = jps.make_stencil_jacobi(A_j, gs, omega=0.7, n_iters=3,
                                diag=None if d is None else jnp.asarray(d))
    t = tk.make_stencil_jacobi(carry(A_j), gs, omega=0.7, n_iters=3,
                               diag=None if d is None else torch.from_numpy(d))
    np.testing.assert_array_equal(t.taps.numpy(), np.asarray(j.taps))
    b, x = vec(n, 2), vec(n, 3)
    assert_close(t.smooth(torch.from_numpy(b), torch.from_numpy(x)),
                 j.smooth(jnp.asarray(b), jnp.asarray(x)))


@pytest.mark.parametrize("case", CASES)
def test_power_matches(case):
    A_j, gs = grid_operator(case)
    j = jps.make_stencil_power(A_j, gs, n_iters=10)
    t = tk.make_stencil_power(carry(A_j), gs, n_iters=10)
    b0 = vec(A_j.n_rows, 4)
    lam_j, b_j = j.run(jnp.asarray(b0))
    lam_t, b_t = t.run(torch.from_numpy(b0))
    assert_close(b_t, b_j)
    np.testing.assert_allclose(float(lam_t), float(lam_j), rtol=RTOL)


@pytest.mark.parametrize("case", CASES)
def test_residual_matches(case):
    A_j, gs = grid_operator(case)
    j = jps.make_stencil_residual(A_j, gs)
    t = tk.make_stencil_residual(carry(A_j), gs)
    np.testing.assert_array_equal(t.taps.numpy(), np.asarray(j.taps))
    b, x = vec(A_j.n_rows, 5), vec(A_j.n_rows, 6)
    assert_close(t.residual(torch.from_numpy(b), torch.from_numpy(x)),
                 j.residual(jnp.asarray(b), jnp.asarray(x)))


@pytest.mark.parametrize("user", ["spmv", "jacobi", "power", "residual"])
def test_bf16_taps_match(user):
    """bf16 taps are rounded from the same float64 planes in both packages
    and widened exactly; the arithmetic stays f32."""
    A_j, gs = grid_operator("nonsym20")
    A_t = carry(A_j)
    n = A_j.n_rows
    x, b = vec(n, 7), vec(n, 8)
    bf_j, bf_t = jnp.bfloat16, torch.bfloat16
    if user == "spmv":
        j = jps.make_stencil_spmv(A_j, gs, 2, tap_dtype=bf_j)
        t = tk.make_stencil_spmv(A_t, gs, 2, tap_dtype=bf_t)
        got, want = (t.matvec_n(torch.from_numpy(x)),
                     j.matvec_n(jnp.asarray(x)))
    elif user == "jacobi":
        j = jps.make_stencil_jacobi(A_j, gs, n_iters=3, tap_dtype=bf_j)
        t = tk.make_stencil_jacobi(A_t, gs, n_iters=3, tap_dtype=bf_t)
        got, want = (t.smooth(torch.from_numpy(b), torch.from_numpy(x)),
                     j.smooth(jnp.asarray(b), jnp.asarray(x)))
    elif user == "power":
        j = jps.make_stencil_power(A_j, gs, n_iters=5, tap_dtype=bf_j)
        t = tk.make_stencil_power(A_t, gs, n_iters=5, tap_dtype=bf_t)
        got, want = t.run(torch.from_numpy(x))[1], j.run(jnp.asarray(x))[1]
    else:
        j = jps.make_stencil_residual(A_j, gs, tap_dtype=bf_j)
        t = tk.make_stencil_residual(A_t, gs, tap_dtype=bf_t)
        got, want = (t.residual(torch.from_numpy(b), torch.from_numpy(x)),
                     j.residual(jnp.asarray(b), jnp.asarray(x)))
    assert t.taps.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t.taps.float().numpy(), np.asarray(j.taps).astype(np.float32))
    assert_close(got, want)


@pytest.mark.parametrize("mode", ["plain", "affine", "normalize"])
def test_plain_version_matches_jnp_twin(mode):
    """stencil_apply_plain == the JAX package's jnp twin iterated, with the
    kernel's affine / normalize epilogue, on the periodic operator."""
    A_j, gs = grid_operator("periodic8")
    shifts, planes = jps.stencil_taps(A_j, gs)
    taps = planes.astype(np.float32).reshape(-1, *gs)
    x, c = vec(A_j.n_rows, 9).reshape(gs), vec(A_j.n_rows, 10).reshape(gs)
    want = jnp.asarray(x)
    for _ in range(3):
        want = jps.stencil_matvec_jnp(jnp.asarray(taps), shifts, want)
        if mode == "affine":
            want = want + jnp.asarray(c)
        elif mode == "normalize":
            want = want / jnp.linalg.norm(want)
    got = ts.stencil_apply_plain(torch.from_numpy(taps), shifts,
                                 torch.from_numpy(x), 3, mode,
                                 torch.from_numpy(c) if mode == "affine"
                                 else None)
    assert_close(got, want)


def test_plain_version_refuses_bad_modes():
    taps = torch.ones(1, 4, 4)
    x = torch.ones(4, 4)
    with pytest.raises(ValueError, match="mode"):
        ts.stencil_apply_plain(taps, [(0, 0)], x, 1, "scaled")
    with pytest.raises(ValueError, match="affine"):
        ts.stencil_apply_plain(taps, [(0, 0)], x, 1, "affine")
    with pytest.raises(ValueError, match="affine"):
        ts.stencil_apply_plain(taps, [(0, 0)], x, 1, "plain", c=x)


def test_spmv_refuses_inputs_that_require_grad():
    """StencilSpMV's backward (once refused here): the gradients in x and
    in the taps equal the plain roll twin's autograd, through the same
    Function the card runs, with no kernel launch on the CPU."""
    A_j, gs = grid_operator("nonsym20")
    s = tk.make_stencil_spmv(carry(A_j), gs, n_steps=2)
    w = torch.from_numpy(vec(A_j.n_rows, 11)).reshape(gs)
    x = torch.from_numpy(vec(A_j.n_rows, 12)).reshape(gs).requires_grad_(
        True)
    s.taps.requires_grad_(True)
    torch.sum(w * s.apply(x)).backward()
    t_ref = s.taps.detach().clone().requires_grad_(True)
    x_ref = x.detach().clone().requires_grad_(True)
    y_ref = ts.stencil_matvec(t_ref, s.shifts,
                              ts.stencil_matvec(t_ref, s.shifts, x_ref))
    torch.sum(w * y_ref).backward()
    assert_close(x.grad, x_ref.grad)
    assert_close(s.taps.grad, t_ref.grad)
    assert s._call.launches == s.launches_t == 0
    with pytest.raises(ValueError, match="n_steps"):
        tk.make_stencil_spmv(carry(A_j), gs, n_steps=0)


@pytest.mark.parametrize("user", ["jacobi", "power", "residual"])
def test_users_refuse_inputs_that_require_grad(user):
    """The JAX package defines no gradient for the Jacobi, power and
    residual users (only PallasStencilSpMV has a VJP), so their K4 calls
    refuse inputs that require grad, on the CPU as on the card: no path
    returns a result whose gradient the other path would cut."""
    A_j, gs = grid_operator("nonsym20")
    A_t = carry(A_j)
    b = torch.ones(A_j.n_rows, requires_grad=True)
    x = torch.zeros(A_j.n_rows)
    with pytest.raises(NotImplementedError, match="defines no VJP"):
        if user == "jacobi":
            tk.make_stencil_jacobi(A_t, gs).smooth(b, x)
        elif user == "power":
            tk.make_stencil_power(A_t, gs).run(b)
        else:
            tk.make_stencil_residual(A_t, gs).residual(b, x)


def test_call_binds_its_grid():
    """A call holds its taps, so shifts and x must lie on the taps' grid:
    shifts built for a larger grid, or an x of another shape, raise."""
    taps = torch.ones(2, 4, 6)
    with pytest.raises(ValueError, match="outside the 4x6 grid"):
        tk.StencilCall([(0, 0), (4, 0)], taps, 1, "plain")
    with pytest.raises(ValueError, match="outside the 4x6 grid"):
        tk.StencilCall([(0, 0), (0, -1)], taps, 1, "plain")
    with pytest.raises(ValueError, match="for 3 shifts"):
        tk.StencilCall([(0, 0), (0, 1), (1, 0)], taps, 1, "plain")
    call = tk.StencilCall([(0, 0), (3, 5)], taps, 2, "plain")
    assert call.grid_shape == (4, 6)
    with pytest.raises(ValueError, match="not on the call's 4x6 grid"):
        call(torch.ones(6, 4))
    y = call(torch.ones(4, 6))
    assert torch.equal(y, torch.full((4, 6), 4.0))


@pytest.mark.parametrize("mode,n_steps,want", [("plain", 3, 3),
                                               ("affine", 1, 1),
                                               ("normalize", 10, 21)])
def test_launches_per_call(mode, n_steps, want):
    """One launch per step; normalize adds a finalize per step and one
    last scaling pass."""
    assert tk.stencil_launches(mode, n_steps) == want
