"""Kernel K3 (the multi-RHS SpMM: `CsrSpMV` on an [n, M] block) and the
gradients of K2 and K3 against the JAX package on the CPU.

The same matrices, made from numpy seeds, go through both packages. The
JAX side runs its stream SpMM in Pallas interpret mode (the real kernel)
or on its numpy emulator (backend="emulate"), as its own tests do; the
port runs its kernels' plain versions, which its wrappers take for CPU
tensors, with the same autograd Functions the card runs.

The JAX values cotangents live in the TPU pack's slot layout. A pack of a
random direction dv on the same pattern puts dv in the same slots, so
<grad, dv> compares the two packages' values gradients exactly.

Tolerances: rtol 1e-4, atol 1e-5 * max (the JAX package's own for its
stream kernel) where a kernel result is compared; the two sum in
different orders in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gnnla_tpu.ops.pallas_stream import (StreamSpMM, StreamSpMV,
                                         build_stream, mrhs_out_to_in,
                                         mrhs_split_out)
from gnnla_tpu.ops.pallas_stream import rcm_csr as j_rcm_csr
from gnnla_tpu.training import spectral_loss as j_sl
from gnnla_tpu_torch.ops.dia import dia_matvec, to_dia
from gnnla_tpu_torch.ops.dia_spmv import dia_kernel_operator
from gnnla_tpu_torch.ops.sparse import SparseOperator as TSparse
from gnnla_tpu_torch.ops.stream_op import csr_pair, stream_operator
from gnnla_tpu_torch.ops.stream_spmv import (CsrSpMV, csr_spmv_plain,
                                             entry_rows)
from gnnla_tpu_torch.problems import laplacian_2d
from gnnla_tpu_torch.training import spectral_loss as t_sl

CPU = "cpu"


def assert_close(got, want, rtol=1e-4, atol_scale=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * np.abs(want).max())


def random_csr(rng, n, max_deg=6):
    """A random square CSR (sorted, coalesced) in RCM order, as the stream
    kernels take it."""
    deg = rng.integers(1, max_deg + 1, n)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    A.sum_duplicates()
    A.sort_indices()
    return j_rcm_csr(A)[0]


def delaunay_laplacian(rng, n):
    from scipy.spatial import Delaunay
    s = Delaunay(rng.random((n, 2))).simplices
    e = np.concatenate([s[:, [0, 1]], s[:, [1, 2]], s[:, [2, 0]]])
    A = sp.coo_matrix((np.ones(e.shape[0], np.float32), (e[:, 0], e[:, 1])),
                      shape=(n, n)).tocsr()
    A = A + A.T
    A.data[:] = -1.0
    lap = (sp.diags(np.asarray(-A.sum(axis=1)).ravel()) + A).tocsr()
    lap.sort_indices()
    return lap.astype(np.float32)


def slot_pack(B, dv, kb):
    """dv (one value per CSR entry of B) in the slot layout of B's pack."""
    Bd = B.copy()
    Bd.data = dv.astype(np.float32)
    return jnp.asarray(build_stream(Bd, kb=kb).vals)


def t(a, requires_grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32,
                        requires_grad=requires_grad)


# ------------------------------------------------------------------ K3
@pytest.mark.parametrize("m", [1, 3, 40])
def test_csr_spmm_plain_matches_scipy(m):
    rng = np.random.default_rng(m)
    B = random_csr(rng, 1500)
    X = rng.standard_normal((1500, m)).astype(np.float32)
    mm, mt = csr_pair(B, CPU, width=1500)
    got = mm(t(X))
    assert got.shape == (1500, m)
    assert_close(got, B @ X)
    rows = entry_rows(mm.row_ptr, mm.nnz)
    assert torch.equal(got, csr_spmv_plain(rows, mm.cols, mm.vals, t(X),
                                           1500))
    assert_close(mt(t(X)), B.T @ X)
    # the CPU runs no kernel
    assert (mm.launches_mm, mt.launches_mm, mm.launches) == (0, 0, 0)


def test_csr_spmm_matches_jax_interpret():
    """K3 against the JAX SpMM kernel in interpret mode at 2048 rows,
    M = 3: a chained apply (the Gelfand iteration's pattern), the X
    cotangent (K3 on the CSR of A^T) and the values cotangent."""
    rng = np.random.default_rng(24601)
    n, M = 2048, 3
    B = (random_csr(rng, n) * 0.5).tocsr()
    jm = StreamSpMM(B, M, interpret=True)
    X = rng.standard_normal((n, M)).astype(np.float32)
    W = rng.standard_normal((n, M)).astype(np.float32)

    # chained apply through the JAX relayout
    x4 = jm.to_padded(jnp.asarray(X))
    y4 = jm.apply(jm.op_args, x4)
    y4b = jm.apply(jm.op_args, mrhs_out_to_in(y4))
    mm, _ = csr_pair(B, CPU, width=n)
    y1 = mm(t(X))
    assert_close(y1, mrhs_split_out(y4, n))
    assert_close(mm(y1), mrhs_split_out(y4b, n))

    # d/dX and d/dvals of <W, A X>
    nt = jm.fmt.n_tiles
    wq = np.zeros((nt * 1024, M), np.float32)
    wq[:n] = W
    w4 = jnp.asarray(wq.reshape(nt, 8, 128, M).transpose(0, 1, 3, 2)
                     .reshape(nt, 8, 128 * M))
    fwd, bwd = jm.op_args

    def f(x4, vslot):
        return jnp.vdot(w4, jm.apply((fwd[:5] + (vslot,), bwd), x4))

    gx4, gv = jax.grad(f, argnums=(0, 1))(x4, fwd[5])
    gx = np.asarray(gx4).reshape(nt, M, 8, 128).transpose(0, 2, 3, 1) \
        .reshape(nt * 1024, M)[:n]

    xt = t(X, requires_grad=True)
    mm.vals.requires_grad_(True)
    torch.sum(t(W) * mm(xt)).backward()
    assert_close(xt.grad, gx)
    assert_close(xt.grad, B.T @ W)
    dv = rng.standard_normal(B.nnz)
    want = float(jnp.vdot(gv, slot_pack(B, dv, jm.fmt.kb)))
    got = float(torch.dot(mm.vals.grad.double(), torch.from_numpy(dv)))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_csr_spmm_on_a_rectangular_pair():
    """One wrapper serves K2 and K3: the linked pair of a rectangular CSR
    (a prolongation's shape) applies [nc] vectors and [nc, M] blocks, and
    the block's X cotangent runs on the transposed CSR."""
    rng = np.random.default_rng(8)
    n, nc, M = 1500, 700, 4
    P = sp.random(n, nc, density=0.004, format="csr", random_state=1,
                  dtype=np.float32)
    P.sort_indices()
    fwd, bwd = csr_pair(P, CPU, width=n)
    X = rng.standard_normal((nc, M)).astype(np.float32)
    W = rng.standard_normal((n, M)).astype(np.float32)
    assert_close(fwd(t(X)), P @ X)
    assert_close(fwd(t(X[:, 0])), P @ X[:, 0])
    assert_close(bwd(t(W)), P.T @ W)
    xt = t(X, requires_grad=True)
    torch.sum(t(W) * fwd(xt)).backward()
    assert_close(xt.grad, P.T @ W)


def test_csr_spmm_grad_needs_only_what_is_asked():
    """The X cotangent runs only when X needs a gradient and the values'
    only when they do (JAX drops the unused one as dead code)."""
    rng = np.random.default_rng(3)
    B = random_csr(rng, 1200)
    X = rng.standard_normal((1200, 2)).astype(np.float32)
    mm, _ = csr_pair(B, CPU, width=1200)
    mm.vals.requires_grad_(True)
    y = mm(t(X))
    assert y.requires_grad
    torch.sum(y).backward()
    want = X[mm.cols.numpy()].sum(axis=1)  # ybar = 1: sum_m x[col, m]
    assert_close(mm.vals.grad, want)
    mm.vals.requires_grad_(False)
    mm.vals.grad = None
    xt = t(X, requires_grad=True)
    torch.sum(mm(xt)).backward()
    assert mm.vals.grad is None and not mm.vals.requires_grad
    assert_close(xt.grad, B.T @ np.ones((1200, 2), np.float32))


def test_csr_spmm_refusals():
    rng = np.random.default_rng(5)
    B = random_csr(rng, 1100)
    X = t(rng.standard_normal((1100, 2)), requires_grad=True)
    no_t = CsrSpMV(B, device=CPU)  # not linked to a transpose
    with pytest.raises(ValueError, match="with_transpose=False"):
        torch.sum(no_t(X)).backward()
    # columns beyond the packed width: a window the JAX packer refuses
    wide = sp.random(1100, 3000, density=0.01, format="csr",
                     random_state=0, dtype=np.float32)
    with pytest.raises(ValueError, match="column window"):
        csr_pair(wide, CPU, width=1100)
    empty = sp.csr_matrix((1100, 1100), dtype=np.float32)
    with pytest.raises(ValueError, match="empty"):
        build_stream(empty)
    with pytest.raises(ValueError, match="empty"):
        csr_pair(empty, CPU, width=1100)
    with pytest.raises(ValueError, match="expects"):
        no_t(t(np.ones((1099, 2))))
    with pytest.raises(ValueError, match="expects"):
        no_t(t(np.ones((1100, 2, 1))))


# ------------------------------------------------------------------ K2
@pytest.mark.parametrize("direction", ["matvec", "rmatvec"])
def test_csr_spmv_grad_matches_jax_vjp(direction):
    """K2's autograd Function (through `StreamOperator`) against the JAX
    `StreamSpMV.apply` / `apply_t` custom VJPs: the vector's cotangent and
    the values' (the forward CSR's for matvec, the transposed CSR's for
    rmatvec, as each JAX apply differentiates its own pack)."""
    rng = np.random.default_rng(11)
    n = 2500
    B = random_csr(rng, n)
    jmv = StreamSpMV(B, backend="emulate")
    S = stream_operator(TSparse.from_scipy(B, device=CPU), reorder=False)
    x = rng.standard_normal(n).astype(np.float32)
    w = rng.standard_normal(n).astype(np.float32)
    fwd, bwd = jmv.op_args
    w3 = jmv.to_padded(jnp.asarray(w))
    if direction == "matvec":
        def f(x3, vslot):
            return jnp.vdot(w3, jmv.apply((fwd[:5] + (vslot,), bwd), x3))
        vslot, kb, own, mat = fwd[5], jmv.fmt.kb, S.fwd, B
    else:
        def f(x3, vslot):
            return jnp.vdot(w3, jmv.apply_t((fwd, bwd[:5] + (vslot,)), x3))
        Bt = B.T.tocsr()
        Bt.sort_indices()
        vslot, kb, own, mat = bwd[5], build_stream(Bt).kb, S.bwd, Bt
    gx3, gv = jax.grad(f, argnums=(0, 1))(jmv.to_padded(jnp.asarray(x)),
                                          vslot)

    xt = t(x, requires_grad=True)
    own.vals.requires_grad_(True)
    try:
        y = getattr(S, direction)(xt)
        torch.sum(t(w) * y).backward()
        dv = rng.standard_normal(mat.nnz)
        got_v = float(torch.dot(own.vals.grad.double(),
                                torch.from_numpy(dv)))
    finally:
        own.vals.requires_grad_(False)
    assert_close(xt.grad, np.asarray(gx3).reshape(-1)[:n])
    want_v = float(jnp.vdot(gv, slot_pack(mat, dv, kb)))
    np.testing.assert_allclose(got_v, want_v, rtol=1e-4)


def test_csr_spmv_without_transpose_has_no_gradient():
    rng = np.random.default_rng(2)
    B = random_csr(rng, 1100)
    csr = CsrSpMV(B, device=CPU)
    x = t(rng.standard_normal(1100), requires_grad=True)
    with pytest.raises(ValueError, match="with_transpose=False"):
        torch.sum(csr(x)).backward()


def test_stream_operator_gradient_in_caller_order():
    """matvec/rmatvec between the RCM gathers carry the gradient of the
    plain COO operator, in x (caller order)."""
    A = laplacian_2d(40, device=CPU).eliminate_zeros()
    rows, cols, vals = A.host_coo()
    new = np.argsort(np.random.default_rng(0).permutation(A.n_rows))
    Ap = TSparse.from_coo(new[rows], new[cols], vals, A.shape, device=CPU)
    S = stream_operator(Ap, reorder=True)
    w = t(np.random.default_rng(1).standard_normal(A.n_rows))
    for name in ("matvec", "rmatvec"):
        x1 = t(np.random.default_rng(2).standard_normal(A.n_rows),
               requires_grad=True)
        x2 = x1.detach().clone().requires_grad_(True)
        torch.sum(w * getattr(S, name)(x1)).backward()
        torch.sum(w * getattr(Ap, name)(x2)).backward()
        assert_close(x1.grad, x2.grad, rtol=1e-5, atol_scale=1e-6)


# ------------------------------------------------------- Gelfand on K3
def test_gelfand_spmm_matches_jax_and_the_coo_path():
    """`damping_factor_gelfand_spmm` and its gradient in the diagonal
    against the JAX package's on an emulated StreamSpMM and against the
    port's COO path (the test_stream.py flow on a 3000-point Delaunay
    Laplacian), then gradient steps lower it."""
    rng = np.random.default_rng(24601)
    lap = delaunay_laplacian(rng, 3000) / 8.0
    n = lap.shape[0]
    B, perm = j_rcm_csr(lap.tocsr())
    m, omega = 4, 2.0 / 3.0
    probes = j_sl.uniform_probes(n, m, rng).astype(np.float32)
    diag0 = lap.diagonal().astype(np.float32)

    jm = StreamSpMM(B, m, backend="emulate")
    pj = jnp.asarray(perm, jnp.int32)
    probes4 = jm.to_padded(jnp.asarray(probes)[pj])
    nt = jm.fmt.n_tiles

    def j_loss(d):
        d3 = jnp.pad(d[pj], (0, nt * 1024 - n),
                     constant_values=1.0).reshape(nt, 8, 128)
        return j_sl.damping_factor_gelfand_spmm(jm.apply, jm.op_args, d3,
                                                omega, probes4, k=3)

    jl, jg = jax.value_and_grad(j_loss)(jnp.asarray(diag0))

    mm, _ = csr_pair(B, CPU, width=n)
    p = torch.from_numpy(perm.astype(np.int64))
    probes_k = t(probes)[p].contiguous()

    def t_loss(d):
        return t_sl.damping_factor_gelfand_spmm(mm, d[p], omega, probes_k,
                                                k=3)

    d = t(diag0, requires_grad=True)
    loss = t_loss(d)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert_close(d.grad, jg)

    A = TSparse.from_scipy(lap, device=CPU)
    dc = t(diag0, requires_grad=True)
    loss_c = t_sl.damping_factor_gelfand(A, dc, omega, t(probes), k=3)
    loss_c.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_c.detach()),
                               rtol=1e-4)
    np.testing.assert_allclose(d.grad.numpy(), dc.grad.numpy(), rtol=1e-3,
                               atol=1e-5 * float(dc.grad.abs().max()))

    losses, dd = [], t(diag0)
    for _ in range(4):
        dd.requires_grad_(True)
        lo = t_loss(dd)
        g, = torch.autograd.grad(lo, dd)
        losses.append(float(lo.detach()))
        dd = (dd - 0.5 * g).detach()
    assert losses[-1] < losses[0], losses


# ------------------------------------------------------------------ K1
def test_dia_kernel_refuses_inputs_that_require_grad():
    """K1's backward (once refused here): on the CPU its matvec carries
    the gradients in x and in the diagonals that the plain DIA matvec's
    autograd gives, through the same Function the card runs, with no
    kernel launch."""
    A = laplacian_2d(12, device=CPU).eliminate_zeros()
    K1 = dia_kernel_operator(to_dia(A))
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        A.n_rows).astype(np.float32))
    x = torch.ones(A.n_rows, requires_grad=True)
    K1.diags.requires_grad_(True)
    torch.dot(w, K1.matvec(x)).backward()
    d_ref = K1.diags.detach().clone().requires_grad_(True)
    x_ref = torch.ones(A.n_rows, requires_grad=True)
    torch.dot(w, dia_matvec(d_ref, K1.offsets, x_ref)).backward()
    assert_close(x.grad, x_ref.grad, rtol=1e-6, atol_scale=1e-6)
    assert_close(K1.diags.grad, d_ref.grad, rtol=1e-6, atol_scale=1e-6)
    K1.diags.requires_grad_(False)
    assert_close(K1.matvec(x.detach()), A.matvec(x.detach()), rtol=1e-6,
                 atol_scale=1e-6)
    assert K1.launches == 0
