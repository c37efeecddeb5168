"""The gradients of kernels K1 (the DIA SpMV) and K4 (the fused stencil's
SpMV) and K1's bf16 diagonal storage, against the JAX package's custom
VJPs on the CPU.

The same operators and vectors, made from numpy seeds, go through both
packages. The JAX side runs its Pallas kernels in interpret mode (the real
kernels), as tests/test_pallas.py does; the port runs its kernels' plain
versions, which the wrappers take for CPU tensors, inside the same
autograd Functions the card runs.

Tolerances: rtol 1e-5, atol 1e-5 * max|g| — each side sums its products
in f32, in orders that differ (K1 in offset order, the JAX twin's slices;
K4's taps cotangent through two autodiff systems). bf16-stored diagonals
are rounded once from the same f32 values and widened exactly on both
sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnla_tpu.ops import pallas_stencil as jps
from gnnla_tpu.ops.dia import dia_transpose as j_dia_transpose
from gnnla_tpu.ops.dia import to_dia as j_to_dia
from gnnla_tpu.ops.pallas_spmv import make_dia_spmv_padded
from gnnla_tpu.ops.sparse import SparseOperator as JSparse
from gnnla_tpu.problems import laplacian_2d as j_laplacian_2d
from gnnla_tpu.problems import stretched_mesh_matrix as j_stretched
from gnnla_tpu_torch.models.vcycle import (setup_twogrid, setup_with_dia,
                                           vcycle)
from gnnla_tpu_torch.ops import stencil_kernel as tk
from gnnla_tpu_torch.ops.dia import dia_matvec, dia_transpose, to_dia
from gnnla_tpu_torch.ops.dia_spmv import (DiaKernelOperator,
                                          dia_kernel_operator)
from gnnla_tpu_torch.ops.sparse import SparseOperator as TSparse
from gnnla_tpu_torch.ops.stencil import stencil_matvec

RTOL = 1e-5
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    real = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return real(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


def assert_close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def banded_operator(case):
    """A JAX operator: the 16^2 Laplacian, a non-symmetric banded
    operator (random values on a 9-diagonal band of 300 rows, offsets up
    to 37) or the stretched 9-point FEM."""
    if case == "lap16":
        return j_laplacian_2d(16).eliminate_zeros()
    if case == "fem":
        return j_stretched(15, stretch=3.0)
    rng = np.random.default_rng(3)
    n = 300
    offs = np.array([-37, -20, -3, -1, 0, 1, 2, 11, 29])
    rows = np.repeat(np.arange(n), offs.size)
    cols = rows + np.tile(offs, n)
    keep = (cols >= 0) & (cols < n)
    vals = np.where(cols == rows, -4.0, rng.uniform(-1.5, 1.5, rows.size))
    return JSparse.from_coo(rows[keep], cols[keep], vals[keep], (n, n))


def carry(op_j):
    rows, cols, vals = op_j.host_coo()
    return TSparse.from_coo(rows, cols, vals, op_j.shape, device="cpu")


# ------------------------------------------------------------------ K1
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["lap16", "banded", "fem"])
def test_dia_grads_match_jax_vjp(case, dtype):
    """K1's Function: the forward and both cotangents of <w, A x> equal
    the VJP of `make_dia_spmv_padded(dia, diag_dtype).apply` on the
    unpadded part."""
    jd, td = DTYPES[dtype]
    A_j = banded_operator(case)
    n = A_j.n_rows
    x, w = vec(n, 1), vec(n, 2)
    pmv = make_dia_spmv_padded(j_to_dia(A_j), tile=1024, diag_dtype=jd)

    def f(diags, x_pad):
        y = pmv.apply((diags, pmv.diags_t), x_pad)
        return jnp.vdot(pmv.to_padded(jnp.asarray(w)), y), y

    (_, y_j), (gd_j, gx_j) = jax.value_and_grad(f, argnums=(0, 1),
                                                has_aux=True)(
        pmv.diags, pmv.to_padded(jnp.asarray(x)))

    op = dia_kernel_operator(to_dia(carry(A_j)), diag_dtype=td)
    assert op.diags.dtype == td
    op.diags.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = op.matvec(xt)
    torch.dot(torch.from_numpy(w), y).backward()
    assert y.dtype == torch.float32 and op.launches == 0
    assert_close(y.detach(), pmv.from_padded(y_j))
    assert_close(xt.grad, pmv.from_padded(gx_j))
    assert op.diags.grad.dtype == td
    assert_close(op.diags.grad.float(), np.asarray(
        gd_j.astype(jnp.float32))[:, :n])


@pytest.mark.parametrize("case", ["banded", "fem"])
def test_dia_transpose_matches_jax(case):
    A_j = banded_operator(case)
    t_j = j_dia_transpose(j_to_dia(A_j))
    t_t = dia_transpose(to_dia(carry(A_j)))
    assert t_t.offsets == t_j.offsets
    np.testing.assert_array_equal(t_t.diags.numpy(), np.asarray(t_j.diags))
    dense = carry(A_j).to_dense().numpy()
    x = vec(A_j.n_rows, 4)
    assert_close(t_t.matvec(torch.from_numpy(x)), dense.T @ x)


def test_bf16_storage_is_exact_on_the_laplacian():
    """The integer Laplacian (-4, 1) is exact in bf16: the bf16 operator
    gives the f32 operator's bits, forward and x cotangent."""
    A = carry(j_laplacian_2d(20).eliminate_zeros())
    x, w = torch.from_numpy(vec(400, 5)), torch.from_numpy(vec(400, 6))
    outs = []
    for dt in (torch.float32, torch.bfloat16):
        op = dia_kernel_operator(to_dia(A), diag_dtype=dt)
        xg = x.clone().requires_grad_(True)
        y = op.matvec(xg)
        torch.dot(w, y).backward()
        outs.append((y.detach(), xg.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_bf16_plain_version_upcasts_the_stored_diagonals():
    """The plain bf16 version reads the rounded diagonals widened to
    f32, not the f32 values: on the FEM it equals the f32 operator built
    from those rounded values, and diagonal() stays the f32 one."""
    dia = to_dia(carry(j_stretched(15, stretch=3.0)))
    op = dia_kernel_operator(dia, diag_dtype=torch.bfloat16)
    rounded = DiaKernelOperator(dia.diags.to(torch.bfloat16).float(),
                                dia.offsets, dia.n, dia.nnz)
    x = torch.from_numpy(vec(dia.n, 7))
    assert torch.equal(op.matvec(x), rounded.matvec(x))
    assert not torch.equal(op.matvec(x), dia.matvec(x))
    assert torch.equal(op.diagonal(), dia.diagonal())


def test_dia_kernel_refuses_other_dtypes():
    dia = to_dia(carry(j_laplacian_2d(6).eliminate_zeros()))
    for dt in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="diag_dtype"):
            dia_kernel_operator(dia, diag_dtype=dt)


def test_dia_grad_follows_updated_diagonals():
    """The transposed diagonals are built at construction and again when
    the stored ones change in place (an optimizer step): x's cotangent is
    always the current A^T ybar."""
    dia = to_dia(carry(banded_operator("banded")))
    op = dia_kernel_operator(dia)
    w = torch.from_numpy(vec(dia.n, 8))
    with torch.no_grad():
        op.diags.mul_(0.5)
    x = torch.from_numpy(vec(dia.n, 9)).requires_grad_(True)
    torch.dot(w, op.matvec(x)).backward()
    xp = x.detach().clone().requires_grad_(True)
    torch.dot(w, dia_matvec(op.diags, op.offsets, xp)).backward()
    assert_close(x.grad, xp.grad)


def test_dia_kernel_setup_is_differentiable():
    """`setup_with_dia(kernel=True)`: a V-cycle on K1's operators carries
    the gradient in b that the plain COO cycle has."""
    A = carry(j_laplacian_2d(16).eliminate_zeros())
    plain = setup_twogrid(A)
    fast = setup_with_dia(plain, kernel=True)
    assert isinstance(fast.Ac, DiaKernelOperator)
    w = torch.from_numpy(vec(256, 10))
    grads = []
    for s in (plain, fast):
        b = torch.from_numpy(vec(256, 11)).requires_grad_(True)
        torch.dot(w, vcycle(s, b, torch.zeros(256))).backward()
        grads.append(b.grad)
    assert_close(grads[1], grads[0])
    assert fast.A.launches == fast.Ac.launches == 0


# ------------------------------------------------------------------ K4
def grid_operator(case):
    if case == "lap20":
        return j_laplacian_2d(20).eliminate_zeros(), (20, 20)
    if case == "nonsym20":
        A = j_laplacian_2d(20).eliminate_zeros()
        rows, cols, _ = A.host_coo()
        rng = np.random.default_rng(0)
        v = np.where(rows == cols, -4.0, rng.uniform(0.5, 1.5, rows.size))
        return JSparse.from_coo(rows, cols, v, A.shape), (20, 20)
    return j_stretched(13, stretch=3.0), (12, 12)


@pytest.mark.parametrize("case,dtype,n_steps", [
    ("lap20", "f32", 1), ("nonsym20", "f32", 1), ("nonsym20", "f32", 3),
    ("fem12", "f32", 3), ("nonsym20", "bf16", 3)])
def test_stencil_spmv_grads_match_jax_vjp(case, dtype, n_steps):
    """StencilSpMV's Function: the x and taps cotangents of <w, A^n x>
    equal `PallasStencilSpMV.apply`'s custom VJP."""
    jd, td = DTYPES[dtype]
    A_j, gs = grid_operator(case)
    n = A_j.n_rows
    x = vec(n, 12).reshape(gs)
    w = vec(n, 13).reshape(gs)
    s_j = jps.make_stencil_spmv(A_j, gs, n_steps, tap_dtype=jd)
    y_j, vjp = jax.vjp(s_j.apply, s_j.taps, jnp.asarray(x))
    gt_j, gx_j = vjp(jnp.asarray(w))

    s_t = tk.make_stencil_spmv(carry(A_j), gs, n_steps, tap_dtype=td)
    s_t.taps.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = s_t.apply(xt)
    torch.sum(torch.from_numpy(w) * y).backward()
    assert_close(y.detach(), y_j)
    assert_close(xt.grad, gx_j)
    assert s_t.taps.grad.dtype == td
    assert_close(s_t.taps.grad.float(), np.asarray(gt_j.astype(jnp.float32)))
    assert s_t._call.launches == s_t.launches_t == 0


def test_stencil_spmv_x_grad_is_the_transposed_stencil():
    """x's cotangent alone (taps fixed) is (A^T)^n w, the plain twin's."""
    A_j, gs = grid_operator("nonsym20")
    s = tk.make_stencil_spmv(carry(A_j), gs, n_steps=2)
    w = torch.from_numpy(vec(400, 14)).reshape(gs)
    x = torch.from_numpy(vec(400, 15)).reshape(gs).requires_grad_(True)
    torch.sum(w * s.apply(x)).backward()
    xp = x.detach().clone().requires_grad_(True)
    y = stencil_matvec(s.taps, s.shifts, stencil_matvec(s.taps, s.shifts,
                                                          xp))
    torch.sum(w * y).backward()
    assert s.taps.grad is None
    assert_close(x.grad, xp.grad)
