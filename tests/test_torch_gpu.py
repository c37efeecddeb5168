"""Kernels K1 to K9 against their plain PyTorch versions on
the card, their gradients there, K1's bf16 diagonal storage and compact
layout (both launch forms, rebuilds), K3's float4 and scalar variants,
the multilevel and Krylov solvers on the kernels, BSR against K2 and K3,
and the CLI on the card.

Marked `gpu`: run on a machine with an NVIDIA card (and nvcc) with

    python -m pytest -m gpu tests/test_torch_gpu.py

Without a card every test skips (decided inside a fixture, so every
worker collects the same tests). Tolerance: rtol 1e-5, atol
1e-5 * max|y| — kernel and plain version sum in different orders in f32.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _close(got, want):
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    assert bool(((got - want).abs() <= RTOL * want.abs() + RTOL * scale)
                .all()), float((got - want).abs().max())


def _fast(n, device):
    from gnnla_tpu_torch.models.vcycle import (setup_twogrid, setup_with_dia,
                                               setup_with_stream_p)
    from gnnla_tpu_torch.problems import laplacian_2d

    plain = setup_twogrid(laplacian_2d(n, device=device).eliminate_zeros())
    return plain, setup_with_stream_p(setup_with_dia(plain, kernel=True))


@pytest.mark.parametrize("n", [24, 200])
def test_dia_kernel_matches_plain(cuda, n):
    _, fast = _fast(n, cuda)
    for op in (fast.A, fast.Ac):
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            op.n).astype(np.float32)).to(cuda)
        before = op.launches
        _close(op.matvec(x), op.plain().matvec(x))
        assert op.launches == before + 1


@pytest.mark.parametrize("n", [24, 200])
def test_csr_kernel_matches_plain(cuda, n):
    _, fast = _fast(n, cuda)
    for csr in (fast.P.fwd, fast.P.bwd):
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            csr.shape[1]).astype(np.float32)).to(cuda)
        before = csr.launches
        _close(csr(x), csr.plain(x))
        assert csr.launches == before + 1


def test_fast_cycle_matches_plain_and_counts(cuda):
    from gnnla_tpu_torch.models.vcycle import solve

    plain, fast = _fast(64, cuda)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(
        plain.A.n_rows).astype(np.float32)).to(cuda)
    x0 = torch.zeros_like(b)
    got = solve(fast, b, x0, n_cycles=3)
    want = solve(plain, b, x0, n_cycles=3)
    torch.cuda.synchronize()
    assert float((got - want).abs().max() / want.abs().max()) < 2e-5
    assert (fast.A.launches, fast.Ac.launches) == (21, 12)
    assert (fast.P.fwd.launches, fast.P.bwd.launches) == (3, 3)


def test_wrappers_refuse_bad_operands(cuda):
    from gnnla_tpu_torch.ops.dia_spmv import dia_tiles, dia_tiles_spmv_cuda
    from gnnla_tpu_torch.ops.stream_spmv import csr_spmv_cuda

    tiles = dia_tiles(torch.ones(1, 8, device=cuda), (0,))
    with pytest.raises(ValueError, match="float32"):
        dia_tiles_spmv_cuda(tiles, torch.ones(8, device=cuda,
                                              dtype=torch.float64))
    with pytest.raises(ValueError, match="int32"):
        dia_tiles_spmv_cuda(tiles._replace(seg_off=tiles.seg_off.long()),
                            torch.ones(8, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        dia_tiles_spmv_cuda(tiles, torch.ones(16, device=cuda)[::2])
    with pytest.raises(ValueError, match="disagree"):
        dia_tiles_spmv_cuda(tiles, torch.ones(9, device=cuda))
    x, v = torch.ones(8, device=cuda), torch.ones(8, device=cuda)
    for bad in (torch.ones(9, device=cuda), v.double(), v.cpu()):
        for b, d in ((bad, None), (bad, v), (v, bad)):
            with pytest.raises(ValueError, match="b and d"):
                dia_tiles_spmv_cuda(tiles, x, b, d, 0.7)
    with pytest.raises(ValueError, match="b and d"):
        dia_tiles_spmv_cuda(tiles, x, None, v, 0.7)
    rp = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    cols = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        csr_spmv_cuda(rp.long(), cols, torch.ones(1, device=cuda),
                      torch.ones(1, device=cuda), 1)
    y = csr_spmv_cuda(rp, cols, torch.full((1,), 2.0, device=cuda),
                      torch.full((1,), 3.0, device=cuda), 1)
    assert float(y[0]) == 6.0


# ------------------------------------------------------------ K4, stencil
def _grid_op(kind, n, device):
    """A 5-point operator on an n x n grid: the Laplacian or random
    non-symmetric values on its pattern (a shift-sign error shows there)."""
    from gnnla_tpu_torch.ops.sparse import SparseOperator
    from gnnla_tpu_torch.problems import laplacian_2d

    A = laplacian_2d(n, device=device).eliminate_zeros()
    if kind == "lap":
        return A
    rows, cols, _ = A.host_coo()
    rng = np.random.default_rng(7)
    vals = np.where(rows == cols, -4.0, rng.uniform(0.5, 1.5, rows.size))
    return SparseOperator.from_coo(rows, cols, vals, A.shape, device=device)


@pytest.mark.parametrize("tap_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_steps", [1, 2, 3])
@pytest.mark.parametrize("mode", ["plain", "affine", "normalize"])
@pytest.mark.parametrize("shape", [(48, 40), (33, 7)], ids=["48x40", "33x7"])
def test_stencil_kernel_matches_plain(cuda, shape, mode, n_steps, tap_dtype):
    """K4 against its plain version in every mode, both tap types, odd and
    even n_steps, on a non-symmetric 9-point operator with periodic wraps
    (random taps on 9 shift classes). plain/affine round each product and
    sum like the plain version: equal bits. normalize sums the norm in
    another order: rtol n_steps * 64 * 2^-24."""
    from gnnla_tpu_torch.ops.stencil_kernel import (StencilCall,
                                                    stencil_launches)

    h, w = shape
    rng = np.random.default_rng(n_steps)
    shifts = [(dy % h, dx % w) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    taps = torch.from_numpy(rng.uniform(-0.3, 0.3, (9, h, w))).to(
        tap_dtype).to(cuda)
    x = torch.from_numpy(rng.standard_normal((h, w)).astype(
        np.float32)).to(cuda)
    c = (torch.from_numpy(rng.standard_normal((h, w)).astype(
        np.float32)).to(cuda) if mode == "affine" else None)
    call = StencilCall(shifts, taps, n_steps, mode)
    x_before = x.clone()
    got = call(x, c)
    want = call.plain(x, c)
    torch.cuda.synchronize()
    assert torch.equal(x, x_before)  # the caller's x is never written
    assert call.launches == stencil_launches(mode, n_steps, call.form.form)
    if mode == "normalize":
        rtol = n_steps * 64 * 2.0 ** -24
        assert bool(((got - want).abs() <= rtol * want.abs()
                     + rtol * want.abs().max()).all())
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["lap", "nonsym"])
def test_stencil_users_match_plain(cuda, kind):
    from gnnla_tpu_torch.ops.stencil_kernel import (make_stencil_jacobi,
                                                    make_stencil_power,
                                                    make_stencil_residual,
                                                    make_stencil_spmv)

    A = _grid_op(kind, 40, cuda)
    gs = (40, 40)
    rng = np.random.default_rng(2)
    b, x = (torch.from_numpy(rng.standard_normal(1600).astype(
        np.float32)).to(cuda) for _ in range(2))
    spmv = make_stencil_spmv(A, gs, n_steps=2)
    _close(spmv.matvec_n(x), A.matvec(A.matvec(x)))
    res = make_stencil_residual(A, gs)
    _close(res.residual(b, x), b - A.matvec(x))
    jac = make_stencil_jacobi(A, gs, omega=0.7, n_iters=3)
    want = x
    for _ in range(3):
        want = want + 0.7 / A.diagonal() * (b - A.matvec(want))
    torch.cuda.synchronize()
    assert float((jac.smooth(b, x) - want).abs().max()
                 / want.abs().max()) < 1e-5
    lam, v = make_stencil_power(A, gs, n_iters=5).run(x)
    assert bool(torch.isfinite(v).all()) and abs(
        float(torch.linalg.vector_norm(v)) - 1.0) < 1e-5


def test_geometric_cycle_on_the_card(cuda):
    from gnnla_tpu_torch.models.geometric import GeometricVCycle
    from gnnla_tpu_torch.models.vcycle import setup_twogrid, solve

    A = _grid_op("lap", 64, cuda)
    alt = setup_twogrid(A, splitting="alternating")
    g = GeometricVCycle(A, (64, 64), setup=alt)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(
        4096).astype(np.float32)).to(cuda)
    x = torch.zeros_like(b)
    for _ in range(3):
        x = g.run(b, x)
    want = solve(alt, b, torch.zeros_like(b), n_cycles=3)
    torch.cuda.synchronize()
    assert float((x - want).abs().max() / want.abs().max()) < 1e-4
    # one launch a call: the 3-step smoothers in the tile form, the
    # residual and the 4 Ac applies (one step each) per step
    assert (g._pre._call.form.form, g._res._call.form.form,
            g._ac_call.form.form) == ("tile", "step", "step")
    assert sum(c.launches for c in g.kernel_calls()) == 7 * 3


def test_stencil_wrapper_refuses_bad_operands(cuda):
    from gnnla_tpu_torch.ops.stencil_kernel import stencil_cuda

    taps = torch.ones(2, 8, 8, device=cuda)
    sh = torch.zeros(4, dtype=torch.int32, device=cuda)
    x = torch.ones(8, 8, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        stencil_cuda(taps, sh, x.double(), 1, "plain")
    with pytest.raises(ValueError, match="bfloat16"):
        stencil_cuda(taps.half(), sh, x, 1, "plain")
    with pytest.raises(ValueError, match="int32"):
        stencil_cuda(taps, sh.long(), x, 1, "plain")
    with pytest.raises(ValueError, match="disagree"):
        stencil_cuda(taps, sh, torch.ones(8, 9, device=cuda), 1, "plain")
    with pytest.raises(ValueError, match="disagree"):
        stencil_cuda(taps, sh[:2], x, 1, "plain")
    with pytest.raises(ValueError, match="contiguous"):
        stencil_cuda(taps, sh, torch.ones(8, 16, device=cuda)[:, ::2], 1,
                     "plain")
    with pytest.raises(ValueError, match="affine"):
        stencil_cuda(taps, sh, x, 1, "affine")
    with pytest.raises(ValueError, match="n_steps"):
        stencil_cuda(taps, sh, x, 0, "plain")
    with pytest.raises(ValueError, match="taps"):
        stencil_cuda(torch.ones(65, 8, 8, device=cuda),
                     torch.zeros(130, dtype=torch.int32, device=cuda), x, 1,
                     "plain")


def test_stencil_kernel_takes_shifts_modulo_the_grid(cuda):
    """The raw launcher reduces every shift modulo H and W, as the plain
    version's roll does: shifts off by whole grid lengths, negative ones
    included, give the same bits and no read outside x."""
    from gnnla_tpu_torch.ops.stencil import stencil_apply_plain
    from gnnla_tpu_torch.ops.stencil_kernel import stencil_cuda

    h, w = 12, 10
    rng = np.random.default_rng(4)
    shifts = [(0, 0), (1, 0), (h - 1, 0), (0, 1), (0, w - 1)]
    far = [(0, 0), (1 + 2 * h, 0), (-1, 0), (0, 1 - 3 * w), (0, -1)]
    taps = torch.from_numpy(rng.uniform(-1, 1, (5, h, w)).astype(
        np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((h, w)).astype(
        np.float32)).to(cuda)
    sh = torch.tensor([dy for dy, _ in far] + [dx for _, dx in far],
                      dtype=torch.int32, device=cuda)
    got = stencil_cuda(taps, sh, x, 2, "plain")
    torch.cuda.synchronize()
    assert torch.equal(got, stencil_apply_plain(taps, shifts, x, 2, "plain"))


def test_stencil_call_refuses_grad_on_the_card(cuda):
    from gnnla_tpu_torch.ops.stencil_kernel import (make_stencil_jacobi,
                                                    make_stencil_residual)

    A = _grid_op("nonsym", 16, cuda)
    b = torch.ones(256, device=cuda, requires_grad=True)
    x = torch.zeros(256, device=cuda)
    for user in (make_stencil_residual(A, (16, 16)).residual,
                 make_stencil_jacobi(A, (16, 16)).smooth):
        with pytest.raises(NotImplementedError, match="defines no VJP"):
            user(b, x)


def test_stream_leg_on_the_card(cuda):
    """`AutoTwoGrid`'s "stream" leg on a shuffled 80^2 Laplacian (6400 rows,
    no grid, no band): K2 on the RCM-ordered CSR between the perm/iperm
    gathers, both directions against the plain COO operator, and the
    cycle against the plain cycle; 7 K2 launches per cycle."""
    from gnnla_tpu_torch.models.vcycle import (AutoTwoGrid, setup_twogrid,
                                               solve)
    from gnnla_tpu_torch.ops.sparse import SparseOperator

    lap = _grid_op("lap", 80, cuda)
    rows, cols, vals = lap.host_coo()
    new = np.argsort(np.random.default_rng(0).permutation(lap.n_rows))
    A = SparseOperator.from_coo(new[rows], new[cols], vals, lap.shape,
                                device=cuda)
    setup = setup_twogrid(A, seed=0)
    auto = AutoTwoGrid(setup)
    assert auto.layout == "stream", auto.why
    S = auto.setup.A
    assert S.perm is not None and S.perm.device.type == "cuda"
    rng = np.random.default_rng(5)
    x, b = (torch.from_numpy(rng.standard_normal(A.n_rows).astype(
        np.float32)).to(cuda) for _ in range(2))
    S.fwd.launches = S.bwd.launches = 0
    _close(S.matvec(x), A.matvec(x))
    _close(S.rmatvec(x), A.rmatvec(x))
    assert (S.fwd.launches, S.bwd.launches) == (1, 1)
    got = auto.solve(b, torch.zeros_like(b), n_cycles=3)
    want = solve(setup, b, torch.zeros_like(b), n_cycles=3)
    torch.cuda.synchronize()
    assert float((got - want).abs().max() / want.abs().max()) < 1e-4
    assert (S.fwd.launches, S.bwd.launches) == (1 + 21, 1)


def test_caller_order_apply_is_k2_on_the_rcm_csr(cuda):
    """`stream_operator(reorder=True, transpose=False)` on the k-NN-32
    Laplacian of 2^16 points in their own order: its apply is bitwise K2
    on the RCM-ordered CSR of x gathered into that order, gathered back
    (the gathers only move values); one K2 launch and two counted gathers
    an apply. Under a profiler each apply is one `k2.launch` host span and
    two `stream.perm` spans."""
    import scipy.sparse as sp

    from gnnla_tpu_torch.ops.sparse import SparseOperator
    from gnnla_tpu_torch.ops.stream_op import stream_operator
    from gnnla_tpu_torch.ops.stream_spmv import CsrSpMV, rcm_csr
    from gnnla_tpu_torch.scratch.bench_stream import knn_laplacian
    from gnnla_tpu_torch.utils import program as prog

    lap = knn_laplacian(2 ** 16)
    coo = sp.coo_matrix(lap)
    n = lap.shape[0]
    A = SparseOperator.from_coo(coo.row, coo.col, coo.data, (n, n),
                                coalesce=False, device=cuda)
    op = stream_operator(A, reorder=True, transpose=False)
    B, p = rcm_csr(A.to_scipy())
    assert np.array_equal(op.perm.cpu().numpy(), p)
    k2 = CsrSpMV(B, device=cuda)
    iperm = torch.from_numpy(np.argsort(p)).to(cuda)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        n).astype(np.float32)).to(cuda)
    want = k2(x[op.perm])[iperm]
    got = op.matvec(x)
    assert torch.equal(got, want)
    assert (op.fwd.launches, op.gathers) == (1, 2)
    _close(got, A.matvec(x))

    prog.reset()
    with _profiling():
        for _ in range(3):
            op.matvec(x)
    rep = prog.report()
    prog.reset()
    assert (op.fwd.launches, op.gathers) == (4, 8)
    assert rep["k2.launch"]["calls"] == 3
    assert rep["k2.launch"]["device_calls"] == 0
    assert rep["stream.perm"]["calls"] == 6


# ------------------------------------------------ K3, K2's and K1's grads
def _rcm_csr(n, device):
    """(shuffled n^2 Laplacian as a SparseOperator on `device`, its CSR in
    RCM order, the permutation)."""
    from gnnla_tpu_torch.ops.sparse import SparseOperator
    from gnnla_tpu_torch.ops.stream_spmv import rcm_csr

    lap = _grid_op("lap", n, "cpu")
    rows, cols, vals = lap.host_coo()
    new = np.argsort(np.random.default_rng(0).permutation(lap.n_rows))
    A = SparseOperator.from_coo(new[rows], new[cols], -vals, lap.shape,
                                device=device)
    csr = A.to_scipy()
    csr.sort_indices()
    B, perm = rcm_csr(csr.astype(np.float32))
    return A, B, perm


@pytest.mark.parametrize("m", [1, 20, 33, 64])
def test_csr_spmm_kernel_matches_plain(cuda, m):
    from gnnla_tpu_torch.ops.stream_op import csr_pair

    _, B, _ = _rcm_csr(60, "cpu")
    mm, mt = csr_pair(B, cuda, width=B.shape[0])
    x = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (B.shape[0], m)).astype(np.float32)).to(cuda)
    _close(mm(x), mm.plain(x))
    _close(mt(x), mt.plain(x))
    assert (mm.launches_mm, mt.launches_mm) == (1, 1)
    assert (mm.launches, mt.launches) == (0, 0)  # no K2 launch


def test_csr_spmm_gradients_on_the_card(cuda):
    """K3's autograd Function on the card gives the CPU path's X and
    values gradients; the X cotangent is one K3 launch on A^T."""
    from gnnla_tpu_torch.ops.stream_op import csr_pair

    _, B, _ = _rcm_csr(40, "cpu")
    rng = np.random.default_rng(4)
    X = rng.standard_normal((B.shape[0], 5)).astype(np.float32)
    W = rng.standard_normal((B.shape[0], 5)).astype(np.float32)
    grads = {}
    for dev in ("cpu", cuda):
        mm, mt = csr_pair(B, dev, width=B.shape[0])
        x = torch.from_numpy(X).to(dev).requires_grad_(True)
        mm.vals.requires_grad_(True)
        torch.sum(torch.from_numpy(W).to(dev) * mm(x)).backward()
        grads[str(dev)] = (x.grad.cpu(), mm.vals.grad.cpu(),
                           mm.launches_mm, mt.launches_mm)
    (xc, vc, _, _), (xg, vg, la, lt) = grads["cpu"], grads[str(cuda)]
    _close(xg, xc)
    _close(vg, vc)
    assert (la, lt) == (1, 1)


def test_gelfand_spmm_launches_and_gradient_on_the_card(cuda):
    """One value-and-grad of the SpMM Gelfand loss in the diagonal: 3 K3
    launches on A and 2 on A^T (the first step's input, the probe block,
    needs no cotangent); loss and gradient as on the plain COO path."""
    from gnnla_tpu_torch.ops.stream_op import csr_pair
    from gnnla_tpu_torch.training.spectral_loss import (
        damping_factor_gelfand, damping_factor_gelfand_spmm, uniform_probes)

    A, B, perm = _rcm_csr(48, cuda)
    mm, mt = csr_pair(B, cuda, width=B.shape[0])
    n = A.n_rows
    p = torch.from_numpy(perm.astype(np.int64)).to(cuda)
    probes = torch.from_numpy(uniform_probes(
        n, 6, np.random.default_rng(1)).astype(np.float32)).to(cuda)
    d = A.diagonal().clone().requires_grad_(True)
    loss = damping_factor_gelfand_spmm(mm, d[p], 2 / 3,
                                       probes[p].contiguous(), k=3)
    g, = torch.autograd.grad(loss, d)
    assert (mm.launches_mm, mt.launches_mm) == (3, 2)
    d2 = A.diagonal().clone().requires_grad_(True)
    loss2 = damping_factor_gelfand(A, d2, 2 / 3, probes, k=3)
    g2, = torch.autograd.grad(loss2, d2)
    l1, l2 = float(loss.detach()), float(loss2.detach())
    assert abs(l1 - l2) <= 1e-4 * abs(l2)
    assert bool(((g - g2).abs() <= 1e-3 * g2.abs()
                 + 1e-5 * g2.abs().max()).all())


def test_stream_operator_keeps_the_gradient_on_the_card(cuda):
    """The fault K2's backward repairs: a scalar of `StreamOperator`'s
    matvec/rmatvec with x.requires_grad gives the plain operator's x.grad
    on the card (before, the raw launch cut it), and the values gradient
    of the CPU path."""
    from gnnla_tpu_torch.ops.stream_op import stream_operator

    A, _, _ = _rcm_csr(40, cuda)
    S = stream_operator(A, reorder=True)
    rng = np.random.default_rng(6)
    w, x0 = (torch.from_numpy(rng.standard_normal(A.n_rows).astype(
        np.float32)).to(cuda) for _ in range(2))
    S.fwd.launches = S.bwd.launches = 0
    for name in ("matvec", "rmatvec"):
        x1 = x0.clone().requires_grad_(True)
        x2 = x0.clone().requires_grad_(True)
        torch.sum(w * getattr(S, name)(x1)).backward()
        torch.sum(w * getattr(A, name)(x2)).backward()
        _close(x1.grad, x2.grad)
    assert (S.fwd.launches, S.bwd.launches) == (2, 2)
    S_cpu = stream_operator(A.__class__.from_coo(
        *A.host_coo(), A.shape, device="cpu"), reorder=True)
    for op in (S, S_cpu):
        op.fwd.vals.requires_grad_(True)
        torch.sum(w.to(op.fwd.vals.device) * op.matvec(
            x0.to(op.fwd.vals.device))).backward()
    _close(S.fwd.vals.grad, S_cpu.fwd.vals.grad.to(cuda))


def test_dia_kernel_refuses_grad_on_the_card(cuda):
    """K1's backward (once refused here): on the card the gradients in x
    and in the diagonals equal the plain DIA matvec's autograd; one
    launch forward, one backward on the transposed diagonals."""
    from gnnla_tpu_torch.ops.dia import dia_matvec

    _, fast = _fast(24, cuda)
    for op in (fast.A, fast.Ac):
        rng = np.random.default_rng(8)
        x0, w = (torch.from_numpy(rng.standard_normal(op.n).astype(
            np.float32)).to(cuda) for _ in range(2))
        op.launches = 0
        op.diags.requires_grad_(True)
        x = x0.clone().requires_grad_(True)
        torch.dot(w, op.matvec(x)).backward()
        assert op.launches == 2
        d2 = op.diags.detach().clone().requires_grad_(True)
        x2 = x0.clone().requires_grad_(True)
        torch.dot(w, dia_matvec(d2, op.offsets, x2)).backward()
        _close(x.grad, x2.grad)
        _close(op.diags.grad, d2.grad)
        op.diags.requires_grad_(False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_dia_kernel_grads_match_the_cpu(cuda, dtype):
    """K1's Function on the card gives the CPU path's forward and both
    cotangents, f32 and bf16 diagonals, on the 30^2 fast setup's Ac."""
    from gnnla_tpu_torch.ops.dia_spmv import dia_kernel_operator

    out = {}
    for dev in ("cpu", cuda):
        _, fast = _fast(30, dev)
        op = dia_kernel_operator(fast.Ac.plain(), diag_dtype=dtype)
        rng = np.random.default_rng(9)
        x = torch.from_numpy(rng.standard_normal(op.n).astype(
            np.float32)).to(dev).requires_grad_(True)
        w = torch.from_numpy(rng.standard_normal(op.n).astype(
            np.float32)).to(dev)
        op.diags.requires_grad_(True)
        y = op.matvec(x)
        torch.dot(w, y).backward()
        out[str(dev)] = (y.detach().cpu(), x.grad.cpu(),
                         op.diags.grad.float().cpu(), op.launches)
    (yc, xc, dc, _), (yg, xg, dg, n) = out["cpu"], out[str(cuda)]
    for got, want in ((yg, yc), (xg, xc), (dg, dc)):
        scale = float(want.abs().max())
        assert bool(((got - want).abs() <= RTOL * want.abs()
                     + RTOL * scale).all())
    assert n == 2


def test_dia_bf16_kernel_matches_plain(cuda):
    """bf16 diagonals: on the integer Laplacian the f32 kernel's bits, on
    Ac the plain bf16-stored version within f32 rounding."""
    from gnnla_tpu_torch.ops.dia_spmv import dia_kernel_operator

    _, fast = _fast(40, cuda)
    for op in (fast.A, fast.Ac):
        op16 = dia_kernel_operator(op.plain(), diag_dtype=torch.bfloat16)
        x = torch.from_numpy(np.random.default_rng(10).standard_normal(
            op.n).astype(np.float32)).to(cuda)
        y16 = op16.matvec(x)
        _close(y16, op16.plain().matvec(x))
        if op is fast.A:
            assert torch.equal(y16, op.matvec(x))
        assert op16.launches == 1 and op16.diags.dtype == torch.bfloat16


def test_dia_wrapper_refuses_other_diagonal_types(cuda):
    from gnnla_tpu_torch.ops.dia_spmv import dia_tiles, dia_tiles_spmv_cuda

    x = torch.ones(8, device=cuda)
    for dt in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="bfloat16"):
            dia_tiles_spmv_cuda(dia_tiles(torch.ones(
                1, 8, device=cuda, dtype=dt), (0,)), x)
    y = dia_tiles_spmv_cuda(dia_tiles(torch.full(
        (1, 8), 2.0, device=cuda, dtype=torch.bfloat16), (0,)), x)
    assert torch.equal(y, torch.full((8,), 2.0, device=cuda))


@pytest.mark.parametrize("n_steps", [1, 3])
def test_stencil_spmv_grads_on_the_card(cuda, n_steps):
    """StencilSpMV's Function on the card: x and taps cotangents as on
    the CPU; x's cotangent is n_steps K4 launches in the per-step form,
    which both calls take on this 32^2 grid (one step; a 3-step halo past
    twice the tile)."""
    from gnnla_tpu_torch.ops.stencil_kernel import (make_stencil_spmv,
                                                    stencil_launches)

    out = {}
    for dev in ("cpu", cuda):
        A = _grid_op("nonsym", 32, dev)
        s = make_stencil_spmv(A, (32, 32), n_steps)
        rng = np.random.default_rng(11)
        x = torch.from_numpy(rng.standard_normal((32, 32)).astype(
            np.float32)).to(dev).requires_grad_(True)
        w = torch.from_numpy(rng.standard_normal((32, 32)).astype(
            np.float32)).to(dev)
        s.taps.requires_grad_(True)
        torch.sum(w * s.apply(x)).backward()
        out[str(dev)] = (x.grad.cpu(), s.taps.grad.cpu(), s._call.launches,
                         s.launches_t)
    (xc, tc, _, _), (xg, tg, lf, lt) = out["cpu"], out[str(cuda)]
    for got, want in ((xg, xc), (tg, tc)):
        scale = float(want.abs().max())
        assert bool(((got - want).abs() <= RTOL * want.abs()
                     + RTOL * scale).all())
    assert (lf, lt) == (stencil_launches("plain", n_steps, s._call.form.form),
                        stencil_launches("plain", n_steps, s.form_t.form))
    assert s._call.form.form == s.form_t.form == "step"


def test_mg_pcg_on_the_card(cuda):
    """SA mg_pcg on K1 levels at 64^2: the CPU path's x within 2e-5 and
    exact K1 launches per level (3 per cycle, CG's matvec on A_0, one at
    the coarsest: its degree-8 Chebyshev in K1's one-launch form; one
    cycle more than iterations)."""
    from gnnla_tpu_torch.models import (mg_pcg, setup_sa_multigrid,
                                        setup_with_dia_multigrid)
    from gnnla_tpu_torch.ops.dia_spmv import DiaKernelOperator

    b = np.random.default_rng(5).standard_normal(4096).astype(np.float32)
    xs = {}
    for dev in ("cpu", cuda):
        A = _grid_op("lap", 64, dev)
        mg = setup_with_dia_multigrid(setup_sa_multigrid(A, seed=0),
                                      kernel=True)
        bb = torch.from_numpy(b).to(dev)
        x, hist = mg_pcg(mg, bb, torch.zeros_like(bb), n_iters=10,
                         flip_sign=True)
        xs[str(dev)] = x.cpu()
    torch.cuda.synchronize()
    assert all(isinstance(a, DiaKernelOperator) for a in mg.As)
    last = mg.n_levels - 1
    assert [a.launches for a in mg.As] == [
        11 * (1 if i == last else 3 + (i == 0)) for i in range(last + 1)]
    xc = xs["cpu"]
    assert float((xs[str(cuda)] - xc).abs().max() / xc.abs().max()) < 2e-5
    assert float(hist[-1]) < 1e-5 * float(np.linalg.norm(b))


@pytest.mark.parametrize("max_offsets", [100, 18],
                         ids=["coarsest_on_k1", "coarsest_on_k2"])
def test_mg_pcg_on_k1_and_k2(cuda, max_offsets):
    """SA mg_pcg on the 16^3 Laplacian with K1 on the levels within
    `max_offsets` diagonals (7, 265, 147 and 19 at levels 0-3) and K2 on
    the rest and on every P: no COO operator left, the CPU path's x
    within 2e-5 (as on K1 alone: each level's sums in another order in
    f32, carried through 10 iterations), exact launches per operator, one
    cycle more than iterations: 3 a cycle on a K2 level (8 at the
    coarsest: the degree-8 Chebyshev's applies), 1 + 1 on each P, K1's as
    in the test above (one at a K1 coarsest: the Chebyshev form), and
    their nonzeros in K2's tally."""
    from gnnla_tpu_torch.models import (mg_pcg, setup_sa_multigrid,
                                        setup_with_dia_multigrid)
    from gnnla_tpu_torch.ops.dia_spmv import DiaKernelOperator
    from gnnla_tpu_torch.ops.sparse import SparseOperator
    from gnnla_tpu_torch.ops.stream_op import (RectStreamOperator,
                                               StreamOperator)
    from gnnla_tpu_torch.ops.stream_spmv import K2_TALLY
    from gnnla_tpu_torch.problems import laplacian_nd

    b = np.random.default_rng(6).standard_normal(4096).astype(np.float32)
    xs = {}
    tally0 = (K2_TALLY.nnz, K2_TALLY.warp_nnz)
    for dev in ("cpu", cuda):
        A = laplacian_nd((16, 16, 16), device=dev)[0]
        mg = setup_with_dia_multigrid(setup_sa_multigrid(A, seed=0),
                                      max_offsets=max_offsets, kernel=True)
        bb = torch.from_numpy(b).to(dev)
        x, hist = mg_pcg(mg, bb, torch.zeros_like(bb), n_iters=10,
                         flip_sign=True)
        xs[str(dev)] = x.cpu()
    torch.cuda.synchronize()
    last = mg.n_levels - 1
    on_k2 = [isinstance(a, StreamOperator) for a in mg.As]
    assert [isinstance(a, DiaKernelOperator) for a in mg.As] == [
        not k for k in on_k2]
    assert on_k2[1] and on_k2[last] == (max_offsets == 18)
    assert all(isinstance(p, RectStreamOperator) for p in mg.Ps)
    assert not any(isinstance(op, SparseOperator) for op in mg.As + mg.Ps)
    cycles = 11
    for lvl, a in enumerate(mg.As):
        per_cycle = ((8 if on_k2[lvl] else 1) if lvl == last
                     else 3 + (lvl == 0))
        got = a.fwd.launches if on_k2[lvl] else a.launches
        assert got == cycles * per_cycle, (lvl, got)
    assert [(p.fwd.launches, p.bwd.launches) for p in mg.Ps] == [
        (cycles, cycles)] * last
    # each K2 launch added its CSR's nonzeros and its warp blocks' to the
    # tally (P1^T has rows of up to 89 nonzeros)
    k2 = [(a.fwd, a.fwd.launches) for a in mg.As if isinstance(
        a, StreamOperator)] + [(c, c.launches) for p in mg.Ps
                               for c in (p.fwd, p.bwd)]
    assert (K2_TALLY.nnz - tally0[0], K2_TALLY.warp_nnz - tally0[1]) == (
        sum(n * c.nnz for c, n in k2), sum(n * c.warp_nnz for c, n in k2))
    assert mg.Ps[1].bwd.warp_nnz > 0
    xc = xs["cpu"]
    assert float((xs[str(cuda)] - xc).abs().max() / xc.abs().max()) < 2e-5
    assert float(hist[-1]) < 1e-5 * float(np.linalg.norm(b))


def test_amg_pcg_on_the_card(cuda):
    from gnnla_tpu_torch.models import amg_pcg

    plain, fast = _fast(64, cuda)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(
        4096).astype(np.float32)).to(cuda)
    x, _ = amg_pcg(fast, b, torch.zeros_like(b), n_iters=6, flip_sign=True)
    want, _ = amg_pcg(plain, b, torch.zeros_like(b), n_iters=6,
                      flip_sign=True)
    torch.cuda.synchronize()
    assert float((x - want).abs().max() / want.abs().max()) < 1e-4
    assert (fast.A.launches, fast.Ac.launches) == (28, 28)
    assert (fast.P.fwd.launches, fast.P.bwd.launches) == (7, 7)


def test_csr_spmm_wrapper_refuses_bad_operands(cuda):
    from gnnla_tpu_torch.ops.stream_spmv import csr_spmv_cuda

    rp = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    cols = torch.zeros(1, dtype=torch.int32, device=cuda)
    v = torch.full((1,), 2.0, device=cuda)
    x = torch.full((1, 3), 3.0, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        csr_spmv_cuda(rp, cols, v, x.double(), 1)
    with pytest.raises(ValueError, match="int32"):
        csr_spmv_cuda(rp.long(), cols, v, x, 1)
    with pytest.raises(ValueError, match="disagree"):
        csr_spmv_cuda(rp, cols, v, x[None], 1)
    with pytest.raises(ValueError, match="contiguous"):
        csr_spmv_cuda(rp, cols, v, torch.ones(1, 6, device=cuda)[:, ::2], 1)
    assert torch.equal(csr_spmv_cuda(rp, cols, v, x, 1),
                       torch.full((1, 3), 6.0, device=cuda))


@pytest.mark.parametrize("layout", ["dia", "stencil"])
def test_training_loss_on_the_card_matches_the_cpu(cuda, layout):
    """`make_loss_fn` on a tiny bucket: the card's loss and gradients
    equal the CPU's (rtol 1e-4)."""
    from gnnla_tpu_torch.models.trainable_jacobi import TrainableJacobiMLP
    from gnnla_tpu_torch.training.datasets import small_band_dataset
    from gnnla_tpu_torch.training.train_jacobi import (_draw_probes,
                                                       feature_stack,
                                                       make_loss_fn,
                                                       matrix_stack)

    out = {}
    for dev in ("cpu", cuda):
        ds = small_band_dataset(4, n=10, seed=3, device=dev)
        model = TrainableJacobiMLP(generator=1, device=dev)
        fn = make_loss_fn(model, ds, 2 / 3, 3, layout=layout)
        probes = _draw_probes(ds, range(4), 6, np.random.default_rng(0))
        batch = [torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                 for a in (matrix_stack(ds, layout), feature_stack(ds),
                           ds.diags, probes)]
        loss = fn(*batch)
        loss.backward()
        out[str(dev)] = (float(loss), model.layers[0].weight.grad.cpu())
    (lc, gc), (lg, gg) = out["cpu"], out[str(cuda)]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    assert bool(((gg - gc).abs() <= 1e-4 * gc.abs()
                 + 1e-6 * gc.abs().max()).all())


# ------------------------------------- K1's compact layout, K3's variants
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_dia_tiles_on_every_sa_level(cuda, dtype):
    """K1 on the compact layout of every level of the 160^2 SA hierarchy
    (level 0 takes the warp-per-tile form, the coarse levels the split
    form): each form against the plain version, one launch per matvec."""
    from gnnla_tpu_torch.models import (setup_sa_multigrid,
                                        setup_with_dia_multigrid)
    from gnnla_tpu_torch.ops.dia import DIAOperator, dia_transpose
    from gnnla_tpu_torch.ops.dia_spmv import (dia_kernel_operator,
                                              dia_tiles_spmv_cuda)

    mg = setup_with_dia_multigrid(setup_sa_multigrid(
        _grid_op("lap", 160, cuda), seed=0))
    assert all(isinstance(a, DIAOperator) for a in mg.As)
    forms = []
    for lvl, dia in enumerate(mg.As):
        op = dia_kernel_operator(dia, diag_dtype=dtype)
        x = torch.from_numpy(np.random.default_rng(lvl).standard_normal(
            op.n).astype(np.float32)).to(cuda)
        want = op.plain().matvec(x)
        _close(op.matvec(x), want)
        assert op.launches == 1 and op.tiles.seg_vals.dtype == dtype
        other = op.tiles._replace(split=not op.tiles.split)
        _close(dia_tiles_spmv_cuda(other, x), want)
        _close(op.launch_t(x), dia_transpose(op.plain()).matvec(x))
        assert op.launches == 2 and op.rebuilds == 0
        forms.append(op.tiles.split)
    assert forms[0] is False and all(forms[1:])


def test_dia_layout_rebuilds_outside_cycles_only(cuda):
    """Cycles rebuild no K1 layout; a structural zero of Ac made nonzero in
    place is in the next launch (forward and x's cotangent), after one
    rebuild."""
    from gnnla_tpu_torch.models.vcycle import solve
    from gnnla_tpu_torch.ops.dia import dia_matvec

    plain, fast = _fast(48, cuda)
    b = torch.from_numpy(np.random.default_rng(12).standard_normal(
        plain.A.n_rows).astype(np.float32)).to(cuda)
    solve(fast, b, torch.zeros_like(b), n_cycles=3)
    assert fast.A.rebuilds == fast.Ac.rebuilds == 0
    op = fast.Ac
    k = len(op.offsets) - 1  # the widest offset: zero on most tiles
    in_range = torch.arange(op.n, device=cuda) + op.offsets[k] < op.n
    row = int(torch.nonzero((op.diags[k] == 0) & in_range)[0])
    segs = op.tiles.n_segs
    with torch.no_grad():
        op.diags[k, row] = 0.5
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        op.n).astype(np.float32)).to(cuda)
    y = op.matvec(x)
    assert op.rebuilds == 1 and op.tiles.n_segs in (segs, segs + 1)
    _close(y, dia_matvec(op.diags, op.offsets, x))
    x1 = x.clone().requires_grad_(True)
    torch.dot(x, op.matvec(x1)).backward()
    x2 = x.clone().requires_grad_(True)
    torch.dot(x, dia_matvec(op.diags, op.offsets, x2)).backward()
    _close(x1.grad, x2.grad)
    assert op.rebuilds == 1


@pytest.mark.parametrize("m,misaligned", [(7, False), (20, False),
                                          (20, True), (33, True)],
                         ids=["M7", "M20", "M20-misaligned",
                              "M33-misaligned"])
def test_csr_spmm_variants_are_the_csr_order_sum(cuda, m, misaligned):
    """K3's float4 and scalar variants (M not a multiple of 4, X not
    16-byte aligned) give the CSR-order sequential sum bit for bit."""
    from chip_smoke import csr_sequential
    from gnnla_tpu_torch.ops.stream_op import csr_pair

    _, B, _ = _rcm_csr(50, "cpu")
    mm, _ = csr_pair(B, cuda, width=B.shape[0])
    n = B.shape[0]
    X = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (n, m)).astype(np.float32)).to(cuda)
    if misaligned:
        buf = torch.empty(n * m + 1, device=cuda)
        X = buf[1:].view(n, m).copy_(X)
        assert X.data_ptr() % 16 != 0
    y = mm(X)
    _close(y, mm.plain(X))
    assert torch.equal(y, csr_sequential(mm, X))
    assert mm.launches_mm == 1


# ------------------------------- K4's tile form, K2's row blocks, K1's NaNs
@pytest.mark.parametrize("tap_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_steps", [1, 2, 3, 4])
@pytest.mark.parametrize("mode", ["plain", "affine"])
@pytest.mark.parametrize("shape,tile,reach", [
    ((48, 40), (16, 40), 1), ((33, 7), (5, 7), 1), ((64, 64), (16, 32), 2),
    ((40, 128), (32, 128), 1), ((3, 8), (2, 8), 1), ((5, 3), (2, 3), 2)],
    ids=["48x40", "33x7", "64x64-reach2", "40x128", "3x8", "5x3-reach2"])
def test_stencil_tile_form_is_the_plain_version(cuda, shape, tile, reach,
                                                mode, n_steps, tap_dtype):
    """The tile form, forced on tiles that cut the grid unevenly, on grids
    smaller than their halo, with periodic wraps and a reach of 2, with
    one, four and eight columns a thread: the plain version's bits, one
    launch, the caller's x untouched."""
    from gnnla_tpu_torch.ops.stencil import stencil_apply_plain
    from gnnla_tpu_torch.ops.stencil_kernel import (shifts_tensor,
                                                    stencil_cuda, tile_form)

    h, w = shape
    rng = np.random.default_rng(n_steps + 10 * reach)
    shifts = [(dy % h, dx % w) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    if reach > 1:
        shifts += [(reach % h, (1 - reach) % w), ((-reach) % h, reach % w)]
    taps = torch.from_numpy(rng.uniform(-0.3, 0.3, (len(shifts), h, w))).to(
        tap_dtype).to(cuda)
    x, c = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda) for _ in range(2))
    c = c if mode == "affine" else None
    form = tile_form(shifts, shape, n_steps, tap_dtype, tile)
    x_before = x.clone()
    got = stencil_cuda(taps, shifts_tensor(shifts), x, n_steps, mode, c,
                       form)
    want = stencil_apply_plain(taps, shifts, x, n_steps, mode, c)
    torch.cuda.synchronize()
    assert torch.equal(x, x_before)
    assert torch.equal(got, want)


def test_stencil_forms_and_launches_of_the_cycles(cuda):
    """The cycles' K4 calls at 64^2: 7 launches a geometric cycle, 3 a
    stencil AutoTwoGrid cycle, 1 for a 3-step SpMV's x cotangent; a wide
    operator (a reach of 40 at 3 steps) runs per step and matches."""
    from gnnla_tpu_torch.models.vcycle import AutoTwoGrid, setup_twogrid
    from gnnla_tpu_torch.ops.stencil import stencil_apply_plain
    from gnnla_tpu_torch.ops.stencil_kernel import (StencilCall,
                                                    make_stencil_spmv)

    A = _grid_op("nonsym", 64, cuda)
    auto = AutoTwoGrid(setup_twogrid(A))
    assert auto.layout == "stencil"
    calls = auto._stencil.kernel_calls()
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(
        4096).astype(np.float32)).to(cuda)
    auto.run(b, torch.zeros_like(b))
    assert sum(c.launches for c in calls) == 3
    s = make_stencil_spmv(A, (64, 64), 3)
    x = b.reshape(64, 64).clone().requires_grad_(True)
    torch.sum(s.apply(x)).backward()
    assert (s._call.launches, s.launches_t) == (1, 1)
    rng = np.random.default_rng(2)
    wide = [(0, 0), (1, 0), (63, 0), (40, 3), (24, 61)]
    taps = torch.from_numpy(rng.uniform(-0.3, 0.3, (5, 64, 64)).astype(
        np.float32)).to(cuda)
    call = StencilCall(wide, taps, 3, "plain")
    assert call.form.form == "step"
    y = call(b.reshape(64, 64))
    torch.cuda.synchronize()
    assert call.launches == 3
    assert torch.equal(y, stencil_apply_plain(taps, wide, b.reshape(64, 64),
                                              3, "plain"))


def test_stencil_leg_coarse_correction_on_k1_and_k2(cuda):
    """AutoTwoGrid's stencil leg on the card: Ac (the DIA twin, its dense
    diagonals on the host) on K1 and P on K2, with exact launches a cycle
    (3 K4, 4 K1 on Ac for the degree-4 Chebyshev, one K2 each for P^T and
    P); x after 5 cycles matches the same cycle with the plain DIA Ac on
    the card and the COO P within RTOL (K1's and K2's sum order)."""
    import copy
    import dataclasses

    from gnnla_tpu_torch.models.vcycle import setup_auto
    from gnnla_tpu_torch.ops.dia import to_dia
    from gnnla_tpu_torch.ops.dia_spmv import DiaKernelOperator
    from gnnla_tpu_torch.ops.stream_op import RectStreamOperator
    from gnnla_tpu_torch.problems import laplacian_2d

    auto = setup_auto(laplacian_2d(64, device=cuda).eliminate_zeros())
    assert auto.layout == "stencil"
    sv = auto._stencil
    Ac, P = sv.setup.Ac, sv.setup.P
    assert type(Ac) is DiaKernelOperator and type(P) is RectStreamOperator
    assert Ac.diags.device.type == "cpu"
    assert Ac.tiles.seg_vals.is_cuda and Ac.diagonal().is_cuda
    counted = sv.kernel_calls() + [Ac, P.bwd, P.fwd]
    for obj in counted:
        obj.launches = 0
    b = _rand(64 * 64, 6, cuda)
    x = auto.solve(b, torch.zeros_like(b), n_cycles=5)
    assert [obj.launches for obj in counted] == [10, 5, 20, 5, 5]
    plain = copy.copy(sv)
    plain.setup = dataclasses.replace(sv.setup, Ac=to_dia(auto.setup.Ac),
                                      P=auto.setup.P)
    want = torch.zeros_like(b)
    for _ in range(5):
        want = plain.cycle(b, want)
    _close(x, want)


def test_dia_kernel_layout_built_on_the_host(cuda):
    """A K1 operator whose diagonals stay on the host and whose layouts
    are on the card launches the same kernel on the same layout: bitwise
    the operator built on the card, one launch each; its diagonal() lies
    on the card."""
    from gnnla_tpu_torch.ops.dia_spmv import DiaKernelOperator

    _, fast = _fast(64, cuda)
    Ac = fast.Ac
    host = DiaKernelOperator(Ac.diags.cpu(), Ac.offsets, Ac.n, Ac.nnz,
                             device=cuda)
    assert host.diags.device.type == "cpu" and host.tiles.seg_vals.is_cuda
    x = _rand(Ac.n, 7, cuda)
    y = host.matvec(x)
    assert torch.equal(y, Ac.matvec(x)) and host.launches == 1
    assert torch.equal(host.diagonal(), Ac.diagonal())


def _power_law_csr(n, seed):
    """Rows of 1 to 3,000 nonzeros (a Zipf tail), distinct columns."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    lens = np.minimum(rng.zipf(1.6, n), 3000)
    lens[5] = 3000
    rows = np.repeat(np.arange(n), lens)
    cols = np.concatenate([rng.choice(n, k, replace=False) for k in lens])
    A = sp.csr_matrix((rng.standard_normal(rows.size).astype(np.float32),
                       (rows, cols)), shape=(n, n))
    A.sort_indices()
    return A


def test_csr_kernel_is_the_csr_order_sum(cuda):
    """K2 on P, P^T (the 64^2 fast setup), A_rcm and A_rcm^T (a shuffled
    80^2 Laplacian) and on a CSR shaped as the 3-D SA hierarchy's second
    coarse level (rows of 33 to 120 nonzeros, most in warp blocks):
    bitwise the CSR-order mul-then-add; on a power-law pattern with rows
    of up to 3,000 nonzeros (rows of more than 256 summed by a whole
    block) the plain version within rtol, and its rows of at most 256
    bitwise; one launch each."""
    from chip_smoke import csr_sequential, sa_coarse_csr
    from gnnla_tpu_torch.ops.stream_op import stream_operator
    from gnnla_tpu_torch.ops.stream_spmv import WARP_ROW, CsrSpMV

    _, fast = _fast(64, cuda)
    A, _, _ = _rcm_csr(80, cuda)
    S = stream_operator(A, reorder=True)
    sa = CsrSpMV(sa_coarse_csr(20_000, 5), device=cuda)
    assert sa.warp_rows > 10_000 and sa.long_rows == 0
    for csr in (fast.P.fwd, fast.P.bwd, S.fwd, S.bwd, sa):
        x = torch.from_numpy(np.random.default_rng(2).standard_normal(
            csr.shape[1]).astype(np.float32)).to(cuda)
        csr.launches = 0
        y = csr(x)
        assert csr.launches == 1 and csr.long_rows == 0
        assert torch.equal(y, csr_sequential(csr, x[:, None])[:, 0])
        _close(y, csr.plain(x))
    pl = CsrSpMV(_power_law_csr(5000, 3), device=cuda)
    assert pl.long_rows > 0 and pl.warp_rows > 0
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        5000).astype(np.float32)).to(cuda)
    y = pl(x)
    _close(y, pl.plain(x))
    upto = pl.row_ptr.diff() <= WARP_ROW
    assert torch.equal(y[upto], csr_sequential(pl, x[:, None])[upto, 0])
    assert pl.launches == 1


def test_csr_kernel_grads_match_the_plain_version(cuda):
    """K2's autograd on the row-block kernel: x's and the values'
    cotangents of the plain CSR version's autograd, on the power-law
    pattern (long rows both ways)."""
    from gnnla_tpu_torch.ops.stream_op import csr_pair
    from gnnla_tpu_torch.ops.stream_spmv import csr_spmv_plain, entry_rows

    B = _power_law_csr(3000, 5)
    fwd, _ = csr_pair(B, cuda, width=3000)
    rng = np.random.default_rng(6)
    x0, w = (torch.from_numpy(rng.standard_normal(3000).astype(
        np.float32)).to(cuda) for _ in range(2))
    x = x0.clone().requires_grad_(True)
    fwd.vals.requires_grad_(True)
    torch.dot(w, fwd(x)).backward()
    x2 = x0.clone().requires_grad_(True)
    v2 = fwd.vals.detach().clone().requires_grad_(True)
    torch.dot(w, csr_spmv_plain(entry_rows(fwd.row_ptr, fwd.nnz), fwd.cols,
                                v2, x2, 3000)).backward()
    _close(x.grad, x2.grad)
    _close(fwd.vals.grad, v2.grad)
    assert (fwd.launches, fwd.transpose.launches) == (1, 1)
    fwd.vals.requires_grad_(False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_dia_kernel_gives_the_reference_nans(cuda, dtype):
    """x with +inf, -inf and NaN at columns some rows reach only through
    a skipped segment: on the 40^2 fast Ac and its transpose (x's
    cotangent), both launch forms, K1 gives the plain version's NaN and
    inf positions exactly, the finite entries within rtol, leaves its
    state zeroed and rebuilds nothing; finite x is unchanged."""
    from chip_smoke import nonfinite_probe
    from gnnla_tpu_torch.ops.dia import dia_transpose
    from gnnla_tpu_torch.ops.dia_spmv import (dia_kernel_operator,
                                              dia_tiles_spmv_cuda)

    _, fast = _fast(40, cuda)
    op = dia_kernel_operator(fast.Ac.plain(), diag_dtype=dtype)
    t = dia_transpose(op.plain())
    for tiles, plain_op, seed in ((op.tiles, op.plain(), 1),
                                  (op.tiles_t, t, 2)):
        cols, rows = nonfinite_probe(tiles, 3, seed)
        assert len(cols) == 3
        x_fin = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            op.n).astype(np.float32)).to(cuda)
        y_fin = dia_tiles_spmv_cuda(tiles, x_fin)
        x = x_fin.clone()
        x[cols] = torch.tensor([float("inf"), float("-inf"), float("nan")],
                               device=cuda)
        want = plain_op.matvec(x)
        assert bool(torch.isnan(want[rows]).all())
        for split in (False, True):
            got = dia_tiles_spmv_cuda(tiles._replace(split=split), x)
            torch.cuda.synchronize()
            for test in (torch.isnan, torch.isposinf, torch.isneginf):
                assert torch.equal(test(got), test(want))
            fin = torch.isfinite(want)
            _close(got[fin], want[fin])
            assert tiles.state.tolist() == [0, 0]
        # the next launch on finite x sees no stale flag
        assert torch.equal(dia_tiles_spmv_cuda(tiles, x_fin), y_fin)
    assert op.rebuilds == 0


def _same_bits(got, want):
    """Equal NaN positions, and every other entry equal bit for bit."""
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan]), float(
        (got[~nan] - want[~nan]).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_dia_fused_forms_give_the_eager_bits(cuda, dtype):
    """K1's Jacobi form against x + (w / d) * (b - K1(x)) and its residual
    form against b - K1(x), bit for bit (each step rounds as the eager
    chain does): on the 40^2 Laplacian (its layout needs no state) and
    its fast Ac (it does), each layout in the warp-per-tile and the split
    form, with A's diagonal and a trained D; and with +inf, -inf and NaN
    in x at columns some rows reach only through a skipped segment: the
    NaN rows the eager chain's, the rest bit for bit, the state zeroed.
    Through the operator (`jacobi`, `residual`) each sweep and residual
    is one launch, counted in `launches` and `fused_launches`."""
    from chip_smoke import nonfinite_probe
    from gnnla_tpu_torch.models import jacobi, residual
    from gnnla_tpu_torch.ops.dia_spmv import (dia_kernel_operator,
                                              dia_tiles_spmv_cuda)

    _, fast = _fast(40, cuda)
    seen = set()
    for seed, A in enumerate((fast.A, fast.Ac)):
        op = dia_kernel_operator(A.plain(), diag_dtype=dtype)
        b, x = _rand(op.n, seed, cuda), _rand(op.n, seed + 10, cuda)
        trained = op.diagonal() * (1.0 + 0.3 * _rand(op.n, seed + 20,
                                                       cuda).abs())
        xs = [x]
        cols, _ = nonfinite_probe(op.tiles, 3, seed)
        if cols:
            xs.append(x.clone())
            xs[1][cols] = torch.tensor(
                [float("inf"), float("-inf"), float("nan")], device=cuda)
        for split in (False, True):
            tiles = op.tiles._replace(split=split)
            seen.add((split, tiles.repair, len(xs)))
            for xx in xs:
                y = dia_tiles_spmv_cuda(tiles, xx)
                for d in (op.diagonal(), trained):
                    _same_bits(dia_tiles_spmv_cuda(tiles, xx, b, d, 0.7),
                               xx + (0.7 / d) * (b - y))
                _same_bits(dia_tiles_spmv_cuda(tiles, xx, b), b - y)
                assert tiles.state.tolist() == [0, 0]
        want = x
        for _ in range(3):
            want = want + (0.7 / trained) * (b - op.matvec(want))
        before = (op.launches, op.fused_launches)
        got = jacobi(op, b, x, omega=0.7, n_iters=3, diag=trained)
        r = residual(op, b, x)
        _same_bits(got, want)
        _same_bits(r, b - op.matvec(x))
        assert (op.launches, op.fused_launches) == (before[0] + 5,
                                                    before[1] + 4)
    assert seen == {(False, False, 1), (True, False, 1), (False, True, 2),
                    (True, True, 2)}


def test_fused_mg_pcg_program_gives_the_unfused_bits(cuda, monkeypatch):
    """The 2-D SA mg_pcg as a program (captured, then replayed) with K1's
    fused forms gives the unfused solve's x and history bit for bit, with
    the same K1 launches per level but the coarsest: the fused ones
    replace plain ones one for one, 3 a cycle on each K1 level that
    smooths, one cycle more than iterations, and none at the coarsest,
    whose degree-8 Chebyshev is one launch of K1's Chebyshev form a cycle
    in place of 8 (`fuses` false takes the form away too)."""
    from gnnla_tpu_torch.models.krylov import mg_pcg
    from gnnla_tpu_torch.ops.dia_spmv import DiaKernelOperator
    from gnnla_tpu_torch.utils.program import program

    mg, b, x0, kw = _sa_solve(cuda, 7)
    k1 = [a for a in mg.As if isinstance(a, DiaKernelOperator)]
    last = mg.As[-1]
    assert len(k1) >= 2 and mg.As[0] is k1[0]
    runs = {}
    for fused in (True, False):
        if not fused:
            monkeypatch.setattr(DiaKernelOperator, "fuses",
                                lambda self, *v: False)
        for a in k1:
            a.launches = a.fused_launches = 0
        prog = program(mg_pcg)
        outs = [prog(mg, b, x0, **kw) for _ in range(3)]
        torch.cuda.synchronize()
        assert (prog.captures, prog.replays) == (1, 2)
        for x, hist in outs[1:]:
            assert torch.equal(x, outs[0][0]) and torch.equal(
                hist, outs[0][1])
        runs[fused] = (outs[0], [(a.launches, a.fused_launches)
                                 for a in k1])
    (x_f, h_f), counts_f = runs[True]
    (x_u, h_u), counts_u = runs[False]
    assert torch.equal(x_f, x_u) and torch.equal(h_f, h_u)
    cycles = 3 * (kw["n_iters"] + 1)  # three calls
    assert [c[0] for c in counts_f[:-1]] == [c[0] for c in counts_u[:-1]]
    assert (counts_f[-1][0], counts_u[-1][0]) == (cycles, 8 * cycles)
    assert [c[1] for c in counts_u] == [0] * len(k1)
    assert [c[1] for c in counts_f] == [
        0 if a is last else 3 * cycles for a in k1]


def _cheb_operator(n, seed, dev):
    """A K1 operator of n rows with random values, diagonally dominant
    (its diagonal the row's absolute sum + 1): dense up to 12 rows (a
    Galerkin coarsest's band), past them on the diagonals 0, +-1, +-32,
    +-33; and the (c, d) of its Gershgorin interval."""
    from gnnla_tpu_torch.ops.dia_spmv import DiaKernelOperator

    offsets = (tuple(range(1 - n, n)) if n <= 12
               else (-33, -32, -1, 0, 1, 32, 33))
    gen = np.random.default_rng(seed)
    diags = gen.uniform(-1.0, 1.0, (len(offsets), n))
    for k, off in enumerate(offsets):  # zero where i + off leaves [0, n)
        diags[k, :max(0, -off)] = 0.0
        diags[k, min(n, n - off):] = 0.0
    k0 = offsets.index(0)
    diags[k0] = 0.0
    radius = np.abs(diags).sum(0)
    diags[k0] = radius + 1.0
    lo, hi = float((diags[k0] - radius).min()), float(
        (diags[k0] + radius).max())
    op = DiaKernelOperator(torch.from_numpy(diags.astype(np.float32)).to(dev),
                           offsets, n, int(np.count_nonzero(diags)))
    return op, 0.5 * (hi - lo), 0.5 * (hi + lo)


def _cheb_both(op, b, x, monkeypatch, **cheb):
    """(the form's x, the eager chain's x on the same K1 operator), with
    each one's K1 launches and `CHEB_TALLY.one_launch` counts."""
    import importlib

    from gnnla_tpu_torch.models import chebyshev
    from gnnla_tpu_torch.ops.dia_spmv import DiaKernelOperator

    tally = importlib.import_module(
        "gnnla_tpu_torch.models.chebyshev").CHEB_TALLY
    out = []
    for form in (True, False):
        if not form:
            monkeypatch.setattr(DiaKernelOperator, "takes_chebyshev",
                                lambda self, *a: False)
        before = (op.launches, tally.one_launch)
        y = chebyshev(op, b, x, **cheb)
        out.append((y, op.launches - before[0],
                    tally.one_launch - before[1]))
    monkeypatch.undo()
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 8])
@pytest.mark.parametrize("rows", [1, 6, 12, 128])
def test_chebyshev_form_gives_the_eager_bits(cuda, monkeypatch, rows, deg):
    """K1's Chebyshev form (`chebyshev` on a K1 operator of at most one
    block's 128 rows) against the eager chain on the same operator (deg
    K1 launches and the vector updates between them): x bit for bit, one
    launch and one count of `one_launch` against deg launches; degree 0
    launches nothing and gives x back."""
    from gnnla_tpu_torch.ops.dia_spmv import chebyshev_fits

    op, c, d = _cheb_operator(rows, rows + deg, cuda)
    assert chebyshev_fits(op.layout(), max(deg, 1))
    b, x = _rand(rows, 1, cuda), _rand(rows, 2, cuda)
    (got, n_form, one), (want, n_eager, zero) = _cheb_both(
        op, b, x, monkeypatch, c=c, d=d, deg=deg)
    assert torch.equal(got, want)
    assert bool(torch.isfinite(want).all())
    assert (n_form, one, n_eager, zero) == ((1, 1, deg, 0) if deg
                                            else (0, 0, 0, 0))


def test_chebyshev_form_keeps_the_nonfinite_rule(cuda, monkeypatch):
    """On a 100-row operator whose diagonals +32 and +33 hold values in
    the first tile's rows only and -33 in the third's (so the other tiles
    skip segments that their rows reach), with inf, -inf and NaN in x at
    columns some rows reach only through a skipped segment: the form's
    NaN rows are the eager chain's, and every other entry its bits; so
    too on a finite x and on a zero x (the first apply runs on it)."""
    from chip_smoke import nonfinite_probe
    from gnnla_tpu_torch.ops.dia_spmv import (DiaKernelOperator,
                                              chebyshev_fits)

    dense, c, d = _cheb_operator(100, 9, cuda)
    diags = dense.diags.clone()
    for off in (32, 33):
        diags[dense.offsets.index(off), 32:] = 0.0
    diags[dense.offsets.index(-33), :64] = 0.0
    diags[dense.offsets.index(-33), 96:] = 0.0
    op = DiaKernelOperator(diags, dense.offsets, 100,
                           int(diags.ne(0).sum()))
    assert op.tiles.repair and chebyshev_fits(op.layout(), 8)
    cols, _ = nonfinite_probe(op.tiles, 3, 0)
    assert len(cols) == 3
    b, x = _rand(op.n, 3, cuda), _rand(op.n, 4, cuda)
    bad = x.clone()
    bad[cols] = torch.tensor([float("inf"), float("-inf"), float("nan")],
                             device=cuda)
    for xx in (x, torch.zeros_like(x), bad):
        for deg in (1, 3, 8):  # the NaN rows spread with the degree
            (got, n_form, _), (want, _, _) = _cheb_both(
                op, b, xx, monkeypatch, c=c, d=d, deg=deg)
            _same_bits(got, want)
            assert n_form == 1
            assert bool(torch.isnan(want).any()) == (xx is bad)
    assert op.tiles.state.tolist() == [0, 0]


def test_chebyshev_past_the_form_takes_plain_launches(cuda, monkeypatch):
    """One row past one block (129 rows of the 1-D Laplacian): the eager
    chain, deg K1 launches, no count of `one_launch`; with one row fewer
    the form, one launch, with the chain's bits."""
    from gnnla_tpu_torch.ops.dia import to_dia
    from gnnla_tpu_torch.ops.dia_spmv import (chebyshev_fits,
                                              dia_kernel_operator)
    from gnnla_tpu_torch.problems import laplacian_nd

    def k1(n):
        return dia_kernel_operator(to_dia(laplacian_nd((n,), device=cuda)[0]))

    for op, launches in ((k1(129), 8), (k1(128), 1)):
        assert chebyshev_fits(op.layout(), 8) == (launches == 1)
        b = _rand(op.n, 5, cuda)
        (got, n, one), (want, _, _) = _cheb_both(
            op, b, torch.zeros_like(b), monkeypatch, c=1.9, d=2.1, deg=8)
        assert (n, one) == (launches, int(launches == 1))
        assert torch.equal(got, want)


def test_chebyshev_form_replays_in_a_captured_mg_pcg(cuda, monkeypatch):
    """program(mg_pcg) on the 64^2 SA hierarchy (coarsest 12 rows on K1):
    the capture and each replay give the eager mg_pcg's x and history bit
    for bit, with the form and without it (the eager chain); each call,
    replays too, adds one form launch and one count of `calls` and of
    `one_launch` a cycle."""
    import importlib

    from gnnla_tpu_torch.models.krylov import mg_pcg
    from gnnla_tpu_torch.ops.dia_spmv import DiaKernelOperator
    from gnnla_tpu_torch.utils.program import program

    tally = importlib.import_module(
        "gnnla_tpu_torch.models.chebyshev").CHEB_TALLY
    mg, b, x0, kw = _sa_solve(cuda, 8)
    last = mg.As[-1]
    assert isinstance(last, DiaKernelOperator) and last.n == 12
    cycles = kw["n_iters"] + 1
    prog = program(mg_pcg)
    last.launches = 0
    before = (tally.calls, tally.one_launch)
    outs = [prog(mg, b, x0, **kw) for _ in range(3)]
    torch.cuda.synchronize()
    assert (prog.captures, prog.replays) == (1, 2)
    assert last.launches == 3 * cycles
    assert (tally.calls - before[0], tally.one_launch - before[1]) == (
        3 * cycles, 3 * cycles)
    eager = mg_pcg(mg, b, x0, **kw)
    monkeypatch.setattr(DiaKernelOperator, "takes_chebyshev",
                        lambda self, *a: False)
    chain = mg_pcg(mg, b, x0, **kw)
    torch.cuda.synchronize()
    for x, hist in outs + [chain]:
        assert torch.equal(x, eager[0]) and torch.equal(hist, eager[1])


# ---------------------------------------------------------- the GN forms
_GN = {}


def _gn_fixture(device):
    """The 64^2 Laplacian on `device`: A, its fast setup, the RCM-ordered
    stream operator of the same matrix and its COO twin, K4's residual,
    Jacobi and power calls, and seeded inputs; built once per device."""
    key = str(device)
    if key not in _GN:
        from gnnla_tpu_torch.ops.dia import to_dia
        from gnnla_tpu_torch.ops.dia_spmv import dia_kernel_operator
        from gnnla_tpu_torch.ops.sparse import SparseOperator
        from gnnla_tpu_torch.ops.stencil_kernel import (make_stencil_jacobi,
                                                        make_stencil_power,
                                                        make_stencil_residual)
        from gnnla_tpu_torch.ops.stream_op import stream_operator

        plain, fast = _fast(64, device)
        A = plain.A
        S = stream_operator(A)
        rp = S.fwd.row_ptr.cpu().numpy()
        A_rcm = SparseOperator.from_coo(
            np.repeat(np.arange(A.n_rows), np.diff(rp)),
            S.fwd.cols.cpu().numpy(),
            S.fwd.vals.cpu().numpy().astype(np.float64), S.fwd.shape,
            coalesce=False, device=device)
        W = A.scale(-1.0)
        gen = np.random.default_rng(47)
        n, nc = A.n_rows, plain.Ac.n_rows

        def vec(*shape):
            return torch.from_numpy(gen.standard_normal(shape).astype(
                np.float32)).to(device)

        _GN[key] = dict(
            A=A, plain=plain, fast=fast, S=S, A_rcm=A_rcm, W=W,
            W_k1=dia_kernel_operator(to_dia(W)), A_nd=A.remove_diagonal(),
            res=make_stencil_residual(A, (64, 64)),
            jac=make_stencil_jacobi(A, (64, 64), omega=0.7, n_iters=3),
            pow=make_stencil_power(A, (64, 64), n_iters=10),
            x=vec(n), b=vec(n), X=vec(n, 20), xc=vec(nc), bc=vec(nc),
            U=vec(n, 8), V=vec(n, 8))
    return _GN[key]


def _gn_forms(f):
    """form -> (GN form's output, [kernel-backed fused outputs], scale of
    the tolerance): one call each."""
    from gnnla_tpu_torch import models as m

    cheb = dict(c=-3.4, d=-4.0, deg=4)
    xk = f["x"][f["S"].perm].contiguous()
    strong = m.soc_classic(f["A_nd"], 0.25)
    coarse = f["plain"].coarse_flags.to(f["x"].dtype)
    return {
        "matvec": lambda: (m.matvec_gnn(f["A"], f["x"]),
                           [m.matvec(f["fast"].A, f["x"])], 1),
        "matvec_rcm": lambda: (m.matvec_gnn(f["A_rcm"], xk),
                               [f["S"].fwd(xk)], 1),
        "matvec_rcm_X20": lambda: (m.matvec_gnn(f["A_rcm"], f["X"]),
                                   [f["S"].fwd(f["X"])], 1),
        "residual": lambda: (m.residual_gnn(f["A"], f["b"], f["x"]),
                             [m.residual(f["fast"].A, f["b"], f["x"]),
                              f["res"].residual(f["b"], f["x"])], 1),
        "weighted_norm": lambda: (
            m.matrix_weighted_norm_gnn(f["W"], f["x"]).reshape(1),
            [m.matrix_weighted_norm(f["W_k1"], f["x"]).reshape(1)], 1),
        "jacobi": lambda: (
            m.jacobi_gnn(f["A"], f["b"], f["x"], omega=0.7, n_iters=3),
            [m.jacobi(f["fast"].A, f["b"], f["x"], omega=0.7, n_iters=3),
             f["jac"].smooth(f["b"], f["x"])], 3),
        "chebyshev": lambda: (
            m.chebyshev_gnn(f["plain"].Ac, f["bc"], f["xc"], **cheb),
            [m.chebyshev(f["fast"].Ac, f["bc"], f["xc"], **cheb)], 4),
        "power_lambda": lambda: (
            m.power_method_gnn(f["A"], f["x"], n_iters=10)[0].reshape(1),
            [m.power_method(f["fast"].A, f["x"], n_iters=10)[0].reshape(1),
             f["pow"].run(f["x"])[0].reshape(1)], 1),
        "power_b": lambda: (
            m.power_method_gnn(f["A"], f["x"], n_iters=10)[1],
            [m.power_method(f["fast"].A, f["x"], n_iters=10)[1],
             f["pow"].run(f["x"])[1]], 10),
        "soc_classic": lambda: (strong, [], 1),
        "soc_sa": lambda: (m.soc_sa(f["A_nd"], f["A"].diagonal()), [], 1),
        "direct_interp": lambda: (
            m.direct_interp(f["A_nd"], f["A"].diagonal(), coarse,
                            (strong > 0).to(coarse.dtype)), [], 1),
        "sddmm": lambda: (
            f["A"].sddmm(f["U"], f["V"]),
            [(f["U"] @ f["V"].T)[f["A"].rows.long(), f["A"].cols.long()]],
            1),
    }


def _close_scaled(got, want, k):
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    got, want = got[fin], want[fin]
    scale = float(want.abs().max())
    tol = k * RTOL * want.abs() + k * RTOL * scale
    assert bool(((got - want).abs() <= tol).all()), float(
        (got - want).abs().max())


@pytest.mark.parametrize("form", ["matvec", "matvec_rcm", "matvec_rcm_X20",
                                  "residual", "weighted_norm", "jacobi",
                                  "chebyshev", "power_lambda", "power_b",
                                  "soc_classic", "soc_sa", "direct_interp",
                                  "sddmm"])
def test_gn_form_on_the_card(cuda, form):
    """Each GN form at 64^2 on the card against its CPU run and against
    its fused forms on the kernels (K1, K2, K3, K4); the tolerance scales
    with the iterations (3 Jacobi sweeps, degree 4, 10x on the power
    iterate)."""
    f_d, f_h = _gn_fixture(cuda), _gn_fixture(torch.device("cpu"))
    got, fused, k = _gn_forms(f_d)[form]()
    want_cpu, _, _ = _gn_forms(f_h)[form]()
    _close_scaled(got.cpu(), want_cpu, k)
    for y in fused:
        _close_scaled(got, y, k)
    if form == "soc_classic":
        assert torch.equal((got > 0).cpu(), want_cpu > 0)


def test_setup_twogrid_device_gnn_on_the_card(cuda):
    """`setup_twogrid(use_device_gnn=True)` on the card: the host setup's
    coarse flags, P and Ac within tests/test_amg.py's tolerances, and the
    CPU's device-GNN setup."""
    from gnnla_tpu_torch.models.vcycle import setup_twogrid
    from gnnla_tpu_torch.problems import laplacian_2d

    kw = dict(theta=0.25, splitting="cljp", seed=0)
    A = laplacian_2d(64, device=cuda).eliminate_zeros()
    got = setup_twogrid(A, use_device_gnn=True, **kw)
    host = setup_twogrid(A, **kw)
    cpu = setup_twogrid(laplacian_2d(64, device="cpu").eliminate_zeros(),
                        use_device_gnn=True, **kw)
    for want in (host, cpu):
        assert torch.equal(got.coarse_flags.cpu(), want.coarse_flags.cpu())
        np.testing.assert_allclose(got.P.to_dense().cpu().numpy(),
                                   want.P.to_dense().cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.Ac.to_dense().cpu().numpy(),
                                   want.Ac.to_dense().cpu().numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_gn_batched_on_the_card(cuda):
    """The per-graph-globals block on 20 small-band matrices batched: the
    card against the CPU and against single-graph calls."""
    from chip_smoke import batch_block
    from gnnla_tpu_torch.core import (GraphState, batch_operators,
                                      unbatch_vertices)
    from gnnla_tpu_torch.training.datasets import small_band_dataset

    outs = {}
    for dev in (cuda, torch.device("cpu")):
        ds = small_band_dataset(20, n=12, device=dev)
        ops = [ds.template.with_values(ds.vals[k]) for k in range(20)]
        big, batch = batch_operators(ops)
        gen = np.random.default_rng(53)
        x = torch.from_numpy(gen.standard_normal(big.n_rows).astype(
            np.float32)).to(dev)
        g = torch.from_numpy(gen.standard_normal((20, 2)).astype(
            np.float32)).to(dev)
        out = batch_block()(big, GraphState(x[:, None], big.vals[:, None],
                                            g), batch)
        outs[dev.type] = out
        if dev.type == "cuda":
            parts = unbatch_vertices(out.vertices, [op.n_rows for op in ops])
            off = 0
            for k, op in enumerate(ops):
                one = batch_block()(op, GraphState(
                    x[off:off + op.n_rows, None], op.vals[:, None], g[k]))
                _close(parts[k], one.vertices)
                _close(out.globals_[k], one.globals_)
                off += op.n_rows
    _close(outs["cuda"].vertices, outs["cpu"].vertices.to(cuda))
    _close(outs["cuda"].globals_, outs["cpu"].globals_.to(cuda))


def _diffusion_serve(dev, n, n_graphs=4):
    """The committed diffusion model's grid-path and edge-path outputs on
    the first graphs of the seed-41 dataset at n x n, on `dev`."""
    from gnnla_tpu_torch.models.diffusion_gnn import DiffusionGNN
    from gnnla_tpu_torch.training.checkpoints import \
        load_diffusion_params_npz
    from gnnla_tpu_torch.training.datasets import cosine_diffusion_dataset
    from gnnla_tpu_torch.training.train_diffusion import (edge_features,
                                                          make_apply,
                                                          make_apply_banded)

    ds = cosine_diffusion_dataset(n_graphs, n=n, seed=41, device=dev)
    model = load_diffusion_params_npz(
        "artifacts/diffusion/params.npz",
        DiffusionGNN(1, 2, 32, encoder=(3, 16), device=dev))
    rel = edge_features(ds, n)
    apply_b, pack = make_apply_banded(model, ds, rel, (n, n))

    def put(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    with torch.no_grad():
        grid = apply_b(put(pack(ds.offdiag_vals)), put(ds.diags),
                       put(ds.globals_))
        edge = make_apply(model, ds, rel)(put(ds.offdiag_vals),
                                          put(ds.diags), put(ds.globals_))
    return grid, edge, put(ds.targets)


@pytest.mark.parametrize("n", [16, 80])
def test_diffusion_serve_on_the_card(cuda, n):
    """The committed model on the card: the grid path against the edge
    path there and against the port's CPU path (rtol 1e-4, atol 1e-5)."""
    from gnnla_tpu_torch.training.train_diffusion import loss_terms

    grid, edge, y = _diffusion_serve(cuda, n)
    grid_cpu, _, y_cpu = _diffusion_serve(torch.device("cpu"), n)
    torch.cuda.synchronize()
    for got, want in ((grid, edge), (grid.cpu(), grid_cpu)):
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-4, atol=1e-5)
    assert float(loss_terms(grid, y)) == pytest.approx(
        float(loss_terms(grid_cpu, y_cpu)), rel=1e-4)


def test_diffusion_train_on_the_card(cuda):
    """Two epochs of `train` on the card and on the CPU from one set of
    parameters: the same histories (rtol 1e-3: f32 sums in another order
    compound through Adam)."""
    from gnnla_tpu_torch.models.diffusion_gnn import DiffusionGNN
    from gnnla_tpu_torch.training.datasets import cosine_diffusion_dataset
    from gnnla_tpu_torch.training.train_diffusion import (
        TrainDiffusionConfig, train)

    cfg = TrainDiffusionConfig(num_matrices=40, n_mesh=12, epochs=2,
                               batch_size=8, n_layers_external=1,
                               n_layers_internal=2, n_hidden=16,
                               encoder=(3, 8), cache_dir=None, log_every=0)
    init = DiffusionGNN(1, 2, 16, encoder=(3, 8), generator=5,
                        device="cpu").state_dict()
    hists = {}
    for dev in (cuda, torch.device("cpu")):
        ds = cosine_diffusion_dataset(40, n=12, seed=41, device=dev)
        model, hists[dev.type] = train(cfg, dataset=ds, init_params=init,
                                       device=dev)
        assert next(model.parameters()).device.type == dev.type
    for key in ("train_loss", "val_loss"):
        assert np.isfinite(hists["cuda"][key]).all()
        np.testing.assert_allclose(hists["cuda"][key], hists["cpu"][key],
                                   rtol=1e-3)


def test_diffusion_evaluation_on_the_card(cuda):
    """`ood_extrapolation` and `freq_study_errors` on the card against the
    CPU (rtol 1e-4)."""
    from gnnla_tpu_torch.evaluation import (freq_study_errors,
                                            ood_extrapolation)
    from gnnla_tpu_torch.models.diffusion_gnn import DiffusionGNN

    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = DiffusionGNN(2, 2, 8, encoder=(2, 4), decoder=(1, 4),
                             generator=7, device=dev)
        out[dev.type] = (ood_extrapolation(None, model, n=8)["loss"],
                         freq_study_errors(None, model, n=8, max_freq=2.0)[1])
    for got, want in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(got, want, rtol=1e-4)


def test_eigen_analysis_on_the_card(cuda):
    """The MLP on the card, the eigenproblems on the host: the non-learned
    arrays equal the CPU run's, the learned ones within rtol 1e-5."""
    from gnnla_tpu_torch.evaluation import eigen_analysis
    from gnnla_tpu_torch.training.datasets import small_band_dataset

    params = "artifacts/jacobi/params.npz"
    got = eigen_analysis(params, small_band_dataset(3, n=10, device=cuda))
    want = eigen_analysis(params, small_band_dataset(3, n=10, device="cpu"))
    for k in want:
        if k in ("evals_learn_DinvA", "diag_learn_Dinv"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-6 * np.abs(want[k]).max())
        else:
            np.testing.assert_array_equal(got[k], want[k])


def test_health_kernel_is_exact(cuda):
    """K5: y == 2 x bitwise on the probe's block and on a ragged length
    (the last CUDA block masked); the probe counts its one launch."""
    from gnnla_tpu_torch.utils.health import (SHAPE, HealthCall,
                                              health_cuda, health_probe)

    gen = np.random.default_rng(11)
    for shape in (SHAPE, (1000,)):
        x = torch.from_numpy(gen.standard_normal(shape).astype(
            np.float32)).to(cuda)
        y = health_cuda(x)
        torch.cuda.synchronize()
        assert torch.equal(y, 2 * x)
    call = HealthCall()
    assert health_probe(device=cuda, call=call) > 0.0
    assert call.launches == 1
    with pytest.raises(ValueError, match="float32"):
        health_cuda(torch.ones(8, 128, device=cuda, dtype=torch.float64))


def test_bsr_on_the_card_against_k2_and_k3(cuda):
    """BSR on a shuffled-then-RCM-ordered 48^2 Laplacian on the card: the
    SpMV against K2 and the M = 20 SpMM against K3 on the same CSR (rtol
    1e-5, atol 1e-5 max|y|), the diagonal exactly; TF32 off for the block
    product."""
    from gnnla_tpu_torch.ops.bsr import permute, to_bsr
    from gnnla_tpu_torch.ops.stream_spmv import CsrSpMV

    assert not torch.backends.cuda.matmul.allow_tf32
    A, B, perm = _rcm_csr(48, cuda)
    A_rcm, _ = permute(A, perm)
    bsr = to_bsr(A_rcm, block_size=128)
    assert bsr.device.type == "cuda"
    csr = CsrSpMV(B, device=cuda)
    gen = np.random.default_rng(12)
    x = torch.from_numpy(gen.standard_normal(A.n_rows).astype(
        np.float32)).to(cuda)
    X = torch.from_numpy(gen.standard_normal((A.n_rows, 20)).astype(
        np.float32)).to(cuda)
    _close(bsr @ x, csr(x))
    _close(bsr @ X, csr(X))
    assert csr.launches == 1 and csr.launches_mm == 1
    assert torch.equal(bsr.diagonal(), A_rcm.diagonal())


def test_cli_lists_the_grid_on_the_card(cuda):
    """`python -m gnnla_tpu_torch.cli diffusion --num-combos` in a
    subprocess on the card's machine."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-m", "gnnla_tpu_torch.cli",
                        "diffusion", "--num-combos"], cwd=root,
                       env=dict(os.environ, PYTHONPATH=root),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "There are 5 total combinations"


# ------------------------------------------------ distribution (1 rank)
def _delaunay_rcm(n, seed=7):
    """scratch/proto_ellw.py's fixture at n points (RCM order, f32)."""
    from gnnla_tpu_torch.scratch.proto_ellw import (delaunay_laplacian,
                                                    rcm_ordered)
    return rcm_ordered(delaunay_laplacian(n, np.random.default_rng(seed)))


def _wide_slots(n, reach, seed):
    """Per-row slots (6 a row, duplicates allowed) within `reach` of the
    diagonal: a window wider than K6's shared-memory budget."""
    gen = np.random.default_rng(seed)
    rows = np.arange(n)[:, None]
    cols = np.clip(rows + gen.integers(-reach, reach + 1, (n, 6)), 0, n - 1)
    return cols, gen.standard_normal((n, 6)).astype(np.float32)


def _ellw_case(case):
    from gnnla_tpu_torch.ops.ellw_spmv import (ELLW_SMEM_BYTES, build_ellw,
                                               from_slots)
    if case == "delaunay":
        return build_ellw(_delaunay_rcm(3000))
    if case == "delaunay_16K":
        return build_ellw(_delaunay_rcm(16384))
    if case == "delaunay_200K":  # 196 tiles: more than the card's SMs
        return build_ellw(_delaunay_rcm(200_000))
    meta = from_slots(*_wide_slots(40_000, 15_000, 3))
    assert meta["W"] * 4 > ELLW_SMEM_BYTES
    return meta


@pytest.mark.parametrize("case", ["delaunay", "slots_wide"])
@pytest.mark.parametrize("path", ["shared", "read-only cache"])
def test_ellw_kernel_is_its_plain_version(cuda, case, path):
    """K6 bitwise its plain version in both window paths, on the
    proto_ellw fixture (3,000 points) and on slots with duplicate columns
    whose window (W * 4 > ELLW_SMEM_BYTES) needs more than two blocks an
    SM can share; on the extents and in the earlier full-slot body; the
    wrapper launches the path W selects."""
    from gnnla_tpu_torch.ops.ellw_spmv import EllwSpMV, ellw_cuda
    meta = _ellw_case(case)
    op = EllwSpMV(meta, device=cuda)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        meta["n"]).astype(np.float32)).to(cuda)
    want = op.plain(x)
    shared = path == "shared"
    for y in (ellw_cuda(op.idx, op.val, op.start, x, op.W, shared, op.seg),
              ellw_cuda(op.idx, op.val, op.start, x, op.W, shared)):
        torch.cuda.synchronize()
        assert torch.equal(y[:op.n], want)
    if op.path == path:
        assert torch.equal(op.matvec(x), want) and op.launches == 1


@pytest.mark.parametrize("case", ["delaunay", "delaunay_16K", "slots_wide",
                                  "delaunay_200K"])
def test_ellw_kernel_keeps_the_nonfinite_pattern(cuda, case):
    """K6 on its extents, on x with +inf, -inf and NaN at rows' first
    columns (which every skipped slot reads) and elsewhere: bitwise the
    plain version where it is not NaN, NaN where it is, in both paths, on
    grids of fewer and of more tiles than the card has SMs."""
    from gnnla_tpu_torch.ops.ellw_spmv import EllwSpMV, ellw_cuda
    meta = _ellw_case(case)
    op = EllwSpMV(meta, device=cuda)
    x = np.random.default_rng(5).standard_normal(meta["n"]).astype(
        np.float32)
    first = (meta["idx"].reshape(op.n_tiles, op.K, 1024)[:, 0].reshape(-1)
             + np.repeat(meta["start"], 1024))[:meta["n"]]
    gen = np.random.default_rng(6)
    for value in (np.inf, -np.inf, np.nan):
        x[first[gen.integers(0, meta["n"], 5)]] = value
        x[gen.integers(0, meta["n"], 5)] = value
    xt = torch.from_numpy(x).to(cuda)
    want = op.plain(xt)
    nan = torch.isnan(want)
    assert bool(nan.any())
    for shared in ((True, False) if op.W * 4 <= 227 * 1024 else (False,)):
        y = ellw_cuda(op.idx, op.val, op.start, xt, op.W, shared,
                      op.seg)[:op.n]
        torch.cuda.synchronize()
        assert torch.equal(torch.isnan(y), nan)
        assert torch.equal(y[~nan], want[~nan])


@pytest.mark.parametrize("n_chunks", [8, 16, 32])
def test_gather_axis1_kernel_is_exact(cuda, n_chunks):
    """K7 bitwise its plain version and numpy's win[idx] * vals."""
    from gnnla_tpu_torch.ops.gather_probe import GatherProbe, axis1_plain
    from gnnla_tpu_torch.scratch.probe_dyngather import axis1_inputs

    win, lo, hi, vals, idx = axis1_inputs(64, n_chunks, 8)
    args = [torch.from_numpy(a).to(cuda) for a in (win, lo, hi, vals)]
    probe = GatherProbe()
    out = probe.axis1(*args)
    torch.cuda.synchronize()
    assert probe.launches["axis1"] == 1
    assert torch.equal(out, axis1_plain(*args))
    assert np.array_equal(out.cpu().numpy(), win[idx] * vals)


@pytest.mark.parametrize("R", [8, 512])
def test_gather_axis0_kernel_is_exact(cuda, R):
    """K8 bitwise its plain version on its lane slabs (the wrapper's path
    at both R), in the earlier whole-window design (R = 8) and through the
    read-only cache."""
    from gnnla_tpu_torch.ops.gather_probe import (GatherProbe, axis0_cuda,
                                                  axis0_path, axis0_plain)
    from gnnla_tpu_torch.scratch.probe_dyngather import axis0_inputs

    assert axis0_path(R) == "slab"
    win, idx = axis0_inputs(R, 4)
    args = [torch.from_numpy(a).to(cuda) for a in (win, idx)]
    probe = GatherProbe()
    out = probe.axis0(*args)
    torch.cuda.synchronize()
    assert probe.launches["axis0"] == 1
    assert torch.equal(out, axis0_plain(*args))
    assert torch.equal(out, torch.gather(args[0], 0,
                                         args[1].long().view(-1, 128))
                       .view(out.shape))
    for path in (("window", "read-only cache") if R == 8
                 else ("read-only cache",)):
        assert torch.equal(axis0_cuda(*args, path=path), out)


@pytest.mark.parametrize("R,n_blocks", [(8, 512), (512, 64), (1816, 2),
                                        (1817, 2), (3, 5)])
def test_gather_axis0_slab_at_the_probe_sizes_and_limits(cuda, R, n_blocks):
    """K8 at the probe's full sizes, at the slab limit (R = 1,816, 227 KB
    of shared memory), just past it (the read-only cache) and on an odd R:
    bitwise its plain version."""
    from gnnla_tpu_torch.ops.gather_probe import (axis0_cuda, axis0_path,
                                                  axis0_plain)
    from gnnla_tpu_torch.scratch.probe_dyngather import axis0_inputs

    assert axis0_path(R) == ("slab" if R <= 1816 else "read-only cache")
    args = [torch.from_numpy(a).to(cuda) for a in axis0_inputs(R, n_blocks)]
    out = axis0_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, axis0_plain(*args))


def test_ablation_variants_are_their_plain_versions(cuda):
    """K9: every variant bitwise its plain version on the ablation's
    fixture at 5,000 points; full bitwise K2 on the same CSR."""
    from gnnla_tpu_torch.ops.stream_ablate import VARIANTS, StreamAblation
    from gnnla_tpu_torch.ops.stream_spmv import CsrSpMV
    from gnnla_tpu_torch.scratch.ablate_stream import fixture
    from gnnla_tpu_torch.scratch.proto_ellw import delaunay_laplacian

    A = fixture(delaunay_laplacian(5000, np.random.default_rng(7)))
    k2 = CsrSpMV(A, device=cuda)
    abl = StreamAblation(k2)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        A.shape[0]).astype(np.float32)).to(cuda)
    y_k2 = k2(x)
    for v in VARIANTS:
        y = abl(v, x)
        torch.cuda.synchronize()
        assert torch.equal(y, abl.plain(v, x)), v
        assert abl.launches[v] == 1
    assert torch.equal(abl("full", x), y_k2)


@pytest.mark.parametrize("module,argv", [
    ("proto_ellw", ["--n", "3000"]), ("probe_dyngather", ["--scale", "64"]),
    ("probe_stream", []), ("ablate_stream", ["--n", "3000"]),
    ("bench_stream", ["4000"]), ("probe_gather", ["--n", "20000"])])
def test_scratch_twin_on_the_card(cuda, module, argv):
    """Each scratch twin's main at a small size on the card (its checks
    raise on failure)."""
    import importlib
    assert importlib.import_module(
        f"gnnla_tpu_torch.scratch.{module}").main(argv) is not None


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A world of one NCCL rank on the card, for the module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    import torch.distributed as dist

    from gnnla_tpu_torch.parallel import (global_row_mesh,
                                          initialize_distributed)
    store = tmp_path_factory.mktemp("nccl") / "rendezvous"
    initialize_distributed(f"file://{store}", 1, 0, device="cuda")
    yield global_row_mesh()
    dist.destroy_process_group()


def test_ring_shift_on_one_rank_is_the_identity(nccl_mesh):
    from gnnla_tpu_torch.parallel.collectives import (axis_group, psum,
                                                      ring_shift)
    g = axis_group(nccl_mesh, "rows")
    x = torch.arange(5.0, device="cuda")
    for offset in (1, -1, 3):
        assert ring_shift(x, offset, g) is x
    assert torch.equal(psum(x, g), x)


def test_sharded_stream_apply_is_k2(nccl_mesh):
    """K2 per shard at one rank with a forced halo: one K2 launch per
    apply, y equal to K2 on the whole RCM-ordered CSR."""
    from gnnla_tpu_torch.ops.stream_spmv import CsrSpMV, rcm_csr
    from gnnla_tpu_torch.parallel import build_sharded_stream
    from gnnla_tpu_torch.problems import laplacian_2d

    A = laplacian_2d(96, device="cuda").eliminate_zeros()
    kern = build_sharded_stream(A, nccl_mesh, min_halo_tiles=1)
    assert kern.h_tiles == 1
    B, perm = rcm_csr(A.to_scipy().tocsr())
    whole = CsrSpMV(B, device=torch.device("cuda"))
    x = np.random.default_rng(3).standard_normal(A.n_rows).astype(
        np.float32)
    y = kern.apply(kern.shard(kern.to_padded(x)))
    assert kern.fwd.launches == 1
    want = whole(torch.from_numpy(x[perm]).cuda())
    _close(y[: A.n_rows], want)


def test_data_parallel_step_on_one_rank(nccl_mesh):
    """train_jacobi with a one-rank "data" mesh gives the run without
    one."""
    from torch.distributed.device_mesh import init_device_mesh

    from gnnla_tpu_torch.training import TrainJacobiConfig, train_jacobi
    cfg = dict(num_matrices=16, n_mesh=10, epochs=2, batch_size=8,
               n_train=12, n_val=2, n_test=2, m_probes=8, cache_dir=None,
               log_every=0)
    data = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    _, h1 = train_jacobi(TrainJacobiConfig(**cfg), mesh=data)
    _, h0 = train_jacobi(TrainJacobiConfig(**cfg))
    for k in ("train_loss", "val_loss", "test_loss"):
        np.testing.assert_allclose(h1[k], h0[k], rtol=1e-6)


def test_graft_entry_on_the_card_matches_the_cpu(cuda):
    """The entry contract's cycle on the card against `entry("cpu")`
    within the contract's tolerance (rtol 2e-5, atol 2e-5 * max|y|), on
    the same input bits; it writes into neither b nor x."""
    from gnnla_tpu_torch import graft_entry

    fn, (setup, b, x) = graft_entry.entry()
    fn_c, args_c = graft_entry.entry(device="cpu")
    assert b.device.type == "cuda"
    assert torch.equal(b.cpu(), args_c[1]) and torch.equal(x.cpu(), args_c[2])
    y = fn(setup, b, x)
    torch.cuda.synchronize()
    want = fn_c(*args_c)
    scale = float(want.abs().max())
    assert bool(((y.cpu() - want).abs() <= 2e-5 * want.abs() + 2e-5 * scale)
                .all()), float((y.cpu() - want).abs().max())
    assert torch.equal(x.cpu(), args_c[2]) and torch.equal(b.cpu(), args_c[1])


# ------------------------------------------------------------------ programs
def _rand(n, seed, dev):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        n).astype(np.float32)).to(dev)


def _replays(prog, call, eager, n_calls=3):
    """Call a program n_calls times: the first captures, each later one
    replays and matches the eager body; no two results share storage."""
    outs = [call() for _ in range(n_calls)]
    want = eager()
    for y in outs:
        _close(y, want)
    assert len({y.data_ptr() for y in outs}) == n_calls
    assert (prog.captures, prog.replays) == (1, n_calls - 1)


def test_grid_cycles_replay_after_their_first_call(cuda):
    """StencilVCycle.run and GeometricVCycle.run capture on their first
    call and replay after, within RTOL of their eager cycle; the K4
    counters read three eager cycles' launches after three calls."""
    from gnnla_tpu_torch.models.geometric import GeometricVCycle
    from gnnla_tpu_torch.models.vcycle import StencilVCycle, setup_twogrid
    from gnnla_tpu_torch.problems import laplacian_2d

    A = laplacian_2d(64, device=cuda).eliminate_zeros()
    b, x = _rand(A.n_rows, 0, cuda), _rand(A.n_rows, 1, cuda)
    for cyc in (StencilVCycle(setup_twogrid(A), (64, 64)),
                GeometricVCycle(A, (64, 64))):
        calls = cyc.kernel_calls()
        _replays(cyc.program, lambda: cyc.run(b, x), lambda: cyc.cycle(b, x))
        per = [c.launches for c in calls]
        for c in calls:
            c.launches = 0
        cyc.cycle(b, x)
        assert per == [4 * c.launches for c in calls]  # 3 runs + 1 eager


def test_auto_two_grid_replays_on_its_layouts(cuda):
    """AutoTwoGrid.run and .solve replay a captured graph after their
    first call on the stencil layout (through StencilVCycle's program)
    and on the dia layout (its own `_run` and `_solve`)."""
    from gnnla_tpu_torch.models.vcycle import setup_auto, solve, vcycle
    from gnnla_tpu_torch.problems import laplacian_2d, laplacian_nd

    grid = setup_auto(laplacian_2d(64, device=cuda).eliminate_zeros())
    assert grid.layout == "stencil"
    b = _rand(64 * 64, 2, cuda)
    x = torch.zeros_like(b)
    _replays(grid._stencil.program, lambda: grid.run(b, x),
             lambda: grid._stencil.cycle(b, x))
    got = grid.solve(b, x, n_cycles=3)
    assert grid._stencil.program.replays == 2 + 3
    want = x
    for _ in range(3):
        want = grid._stencil.cycle(b, want)
    _close(got, want)

    A = laplacian_nd((37 * 41,), device=cuda)[0].eliminate_zeros()
    band = setup_auto(A)
    assert band.layout == "dia"
    b = _rand(A.n_rows, 3, cuda)
    x = torch.zeros_like(b)
    _replays(band._run, lambda: band.run(b, x),
             lambda: vcycle(band.setup, b, x))
    _replays(band._solve, lambda: band.solve(b, x, n_cycles=3),
             lambda: solve(band.setup, b, x, n_cycles=3))


def test_fast_solve_program_counts_exactly_and_recaptures(cuda):
    """program(solve) on the fast setup: after N calls the K1 and K2
    counters read N eager calls' launches; an in-place update of A's
    diagonals makes the next call capture anew (one rebuild, as eagerly),
    and its result matches the eager solve."""
    from gnnla_tpu_torch.models.vcycle import solve
    from gnnla_tpu_torch.utils.program import program

    _, fast = _fast(64, cuda)
    ops = (fast.A, fast.Ac, fast.P.fwd, fast.P.bwd)
    b = _rand(fast.A.n_rows, 4, cuda)
    x = torch.zeros_like(b)
    run = program(solve)
    for op in ops:
        op.launches = 0
    for _ in range(5):
        y = run(fast, b, x, n_cycles=2)
    assert [op.launches for op in ops] == [5 * 14, 5 * 8, 5 * 2, 5 * 2]
    assert (run.captures, run.replays) == (1, 4)
    _close(y, solve(fast, b, x, n_cycles=2))
    with torch.no_grad():
        fast.A.diags.mul_(1.0)
    y = run(fast, b, x, n_cycles=2)
    assert (run.captures, fast.A.rebuilds, fast.Ac.rebuilds) == (2, 1, 0)
    _close(run(fast, b, x, n_cycles=2), solve(fast, b, x, n_cycles=2))
    assert run.replays == 5


def test_programs_nest_and_refuse_grad(cuda):
    """A program of chained StencilVCycle.run calls captures them as one
    graph (the inner program neither warms up nor captures); an input
    that requires grad is refused."""
    from gnnla_tpu_torch.models.vcycle import StencilVCycle, setup_twogrid
    from gnnla_tpu_torch.problems import laplacian_2d
    from gnnla_tpu_torch.utils.program import program

    A = laplacian_2d(64, device=cuda).eliminate_zeros()
    sv = StencilVCycle(setup_twogrid(A), (64, 64))
    b = _rand(A.n_rows, 5, cuda)

    def three(bb, xx):
        for _ in range(3):
            xx = sv.run(bb, xx)
        return xx

    run = program(three)
    x = torch.zeros_like(b)
    run(b, x)
    y = run(b, x)
    assert (run.captures, sv.program.captures, sv.program.replays) == \
        (1, 0, 0)
    want = x
    for _ in range(3):
        want = sv.cycle(b, want)
    _close(y, want)
    with pytest.raises(NotImplementedError, match="requires grad"):
        run(b, x.clone().requires_grad_(True))


def test_a_failing_capture_raises(cuda):
    """A body that synchronises with the host fails its capture, and the
    call raises (it does not run eagerly instead). In a child process:
    a failed capture can leave the CUDA context unusable."""
    import subprocess
    import sys

    code = ("import torch\n"
            "from gnnla_tpu_torch.utils.program import program\n"
            "run = program(lambda x: x * float(x.sum()))\n"
            "x = torch.ones(8, device='cuda')\n"
            "try:\n"
            "    run(x)\n"
            "except RuntimeError:\n"
            "    print('raised')\n"
            "else:\n"
            "    print('returned')\n")
    root = __file__.rsplit("/tests/", 1)[0]
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    # torch raises its AcceleratorError, a RuntimeError
    assert p.stdout.strip() == "raised", (p.stdout, p.stderr[-2000:])


def test_no_cyclic_gc_runs_inside_a_capture(cuda):
    """A program captures with Python's cyclic garbage collector off, and
    leaves it on after: a collection inside the capture could free
    another program's graph held in a reference cycle (a `StencilVCycle`
    and its program), which invalidates the capture."""
    import gc

    from gnnla_tpu_torch.utils.program import program

    seen = []

    def body(x):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
        return x * 2.0

    run = program(body)
    x = _rand(64, 11, cuda)
    assert gc.isenabled()
    run(x)
    _close(run(x), x * 2.0)
    assert seen == [False] and gc.isenabled()


def _sa_hierarchy(dev, field_seed):
    """The SA hierarchy on K1 and K2 of a 64^2 log-normal diffusion
    operator (the re-set-up cell's kind, from `field_seed`)."""
    from gnnla_tpu_torch.models.multigrid import (setup_sa_multigrid,
                                                  setup_with_dia_multigrid)
    from gnnla_tpu_torch.ops.sparse import SparseOperator
    from perfbench.problems import lognormal_fv

    g = lognormal_fv.field((64, 64), 1.0, 0.3,
                           np.random.default_rng(field_seed))
    rows, cols, vals, n = lognormal_fv.assemble(np.exp(g))
    A = SparseOperator.from_coo(rows, cols, vals.astype(np.float32), (n, n),
                                coalesce=False, device=dev)
    return setup_with_dia_multigrid(setup_sa_multigrid(A), kernel=True)


def test_a_program_releases_the_graphs_of_dropped_hierarchies(cuda):
    """One program(mg_pcg) over 8 hierarchies set up in turn, each
    dropped before the next is set up: one graph is held at a time, 7 are
    released, and the card's allocated memory comes back to within 1 MB
    of its reading after the first call."""
    from gnnla_tpu_torch.models.krylov import mg_pcg
    from gnnla_tpu_torch.utils.program import program

    b = _rand(64 * 64, 21, cuda)
    x0 = torch.zeros_like(b)
    run = program(mg_pcg)
    base, mg = None, None
    for k in range(8):
        mg = None   # the previous hierarchy dropped before the next
        mg = _sa_hierarchy(cuda, k)
        x, hist = run(mg, b, x0, n_iters=6)
        torch.cuda.synchronize()
        assert float(hist[-1]) < 1e-3 * float(torch.linalg.vector_norm(b))
        del x, hist
        if base is None:
            base = torch.cuda.memory_allocated()
        assert run.live == 1
    assert (run.captures, run.released, run.replays) == (8, 7, 0)
    assert abs(torch.cuda.memory_allocated() - base) <= 2 ** 20


def test_a_kept_hierarchy_replays_while_others_are_released(cuda):
    """A hierarchy the caller keeps is replayed after others have come and
    gone, with no new capture, and gives the eager solve."""
    from gnnla_tpu_torch.models.krylov import mg_pcg
    from gnnla_tpu_torch.utils.program import program

    b = _rand(64 * 64, 22, cuda)
    x0 = torch.zeros_like(b)
    kept = _sa_hierarchy(cuda, 100)
    run = program(mg_pcg)
    run(kept, b, x0, n_iters=6)
    for k in range(3):
        run(_sa_hierarchy(cuda, 101 + k), b, x0, n_iters=6)
    assert (run.captures, run.released, run.live) == (4, 3, 1)
    x, hist = run(kept, b, x0, n_iters=6)
    assert (run.captures, run.replays) == (4, 1)
    want = mg_pcg(kept, b, x0, n_iters=6)
    torch.cuda.synchronize()
    assert torch.equal(x, want[0]) and torch.equal(hist, want[1])


def test_an_object_at_a_dead_ones_address_never_replays_its_graph(cuda):
    """A static object made after another was collected, at the dead one's
    address (so with its `id`), is captured anew and gives its own
    result, never the released graph's."""
    from gnnla_tpu_torch.utils.program import program

    class Scale:
        def __init__(self, s):
            self.s = s

    run = program(lambda x, h: x * h.s)
    x = _rand(256, 23, cuda)
    h = Scale(2.0)
    dead = id(h)
    _close(run(x, h), 2.0 * x)
    _close(run(x, h), 2.0 * x)
    del h
    assert (run.released, run.live) == (1, 0)
    made = []
    while len(made) < 10000 and (not made or id(made[-1]) != dead):
        made.append(Scale(3.0))
    assert id(made[-1]) == dead
    _close(run(x, made[-1]), 3.0 * x)
    assert (run.captures, run.replays) == (2, 1)


# ------------------------------------------------------------------ spans
def _sa_solve(dev, seed):
    """The SA hierarchy of the 64^2 Laplacian with K1 on its banded
    levels, a right-hand side, x0 and the solve's options."""
    from gnnla_tpu_torch.models.multigrid import (setup_sa_multigrid,
                                                  setup_with_dia_multigrid)
    from gnnla_tpu_torch.problems import laplacian_2d

    A = laplacian_2d(64, device=dev).eliminate_zeros()
    mg = setup_with_dia_multigrid(setup_sa_multigrid(A), kernel=True)
    b = _rand(A.n_rows, seed, dev)
    return mg, b, torch.zeros_like(b), {"n_iters": 4, "flip_sign": True}


def _profiling():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _device_entries(report):
    return {k: (v["device_calls"], v["device_s"]) for k, v in report.items()
            if v["device_calls"]}


def test_a_graph_captured_untraced_holds_no_device_span(cuda):
    """Captured while no profiler records, the solve's graph records no
    timing event, and its replays leave the registry's device entries as
    they were."""
    from gnnla_tpu_torch.models.krylov import mg_pcg
    from gnnla_tpu_torch.utils import program as prog

    mg, b, x0, kw = _sa_solve(cuda, 6)
    run = prog.program(mg_pcg)
    prog.reset()
    run(mg, b, x0, **kw)
    before = _device_entries(prog.report())
    for _ in range(3):
        run(mg, b, x0, **kw)
    (g,) = run._graphs.values()
    assert g.record.spans == [] and g.record.closed == []
    assert _device_entries(prog.report()) == before == {}
    assert (run.captures, run.replays) == (1, 3)


def test_the_first_traced_call_captures_once_and_untraced_calls_replay(
        cuda):
    """The first call while a profiler records captures an instrumented
    graph (one more capture, the warm-up's result returned); the next
    traced call replays it; a call after the profiler stops replays the
    plain graph with no capture. All three match the eager solve."""
    from gnnla_tpu_torch.models.krylov import mg_pcg
    from gnnla_tpu_torch.utils import program as prog

    mg, b, x0, kw = _sa_solve(cuda, 7)
    want = mg_pcg(mg, b, x0, **kw)[0]
    run = prog.program(mg_pcg)
    prog.reset()
    run(mg, b, x0, **kw)
    with _profiling():
        first = run(mg, b, x0, **kw)[0]
        assert (run.captures, run.replays) == (2, 0)
        second = run(mg, b, x0, **kw)[0]
        assert (run.captures, run.replays) == (2, 1)
    third = run(mg, b, x0, **kw)[0]
    assert (run.captures, run.replays) == (2, 2)
    for y in (first, second, third):
        _close(y, want)
    assert sum(1 for g in run._graphs.values() if g.record.spans) == 1
    rep = prog.report()
    assert rep["pcg"]["device_calls"] == 1
    assert rep["program.capture"]["calls"] == 2


def test_device_spans_of_a_replayed_solve_add_up_to_its_pcg_span(cuda):
    """Over replays of the instrumented solve, the self times of every
    device span add up to the `pcg` span within 1%; each level's own time
    is positive, each level lies inside the one above it, and the `pcg`
    span inside the replay's device time."""
    from gnnla_tpu_torch.models.krylov import mg_pcg
    from gnnla_tpu_torch.utils import program as prog

    mg, b, x0, kw = _sa_solve(cuda, 8)
    run = prog.program(mg_pcg)
    prog.reset()
    n = 5
    with _profiling():
        run(mg, b, x0, **kw)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        ms = 0.0
        for _ in range(n):
            t0.record()
            run(mg, b, x0, **kw)
            t1.record()
            torch.cuda.synchronize()
            ms += t0.elapsed_time(t1)
    rep = prog.report()
    dev = {k: v for k, v in rep.items() if v["device_calls"]}
    L = mg.n_levels
    assert set(dev) == {"pcg", "mg.cycle"} | {f"mg.level{lvl}"
                                               for lvl in range(L)}
    pcg = dev["pcg"]
    assert pcg["device_calls"] == n
    assert dev["mg.cycle"]["device_calls"] == n * (kw["n_iters"] + 1)
    total = sum(v["self_device_s"] for v in dev.values())
    assert abs(total - pcg["device_s"]) <= 0.01 * pcg["device_s"]
    assert pcg["device_s"] * 1e3 <= ms
    assert dev["mg.level0"]["parent"] == "mg.cycle"
    assert dev["mg.cycle"]["parent"] == "pcg" and pcg["parent"] is None
    for lvl in range(L):
        assert dev[f"mg.level{lvl}"]["self_device_s"] > 0
        if lvl:
            assert dev[f"mg.level{lvl}"]["parent"] == f"mg.level{lvl - 1}"
            assert dev[f"mg.level{lvl}"]["device_s"] < \
                dev[f"mg.level{lvl - 1}"]["device_s"]


def test_a_guard_mismatch_while_traced_recaptures(cuda):
    """An in-place update of the fine K1 diagonals while a profiler
    records makes the next traced call capture anew (one rebuild), and it
    matches the eager solve."""
    from gnnla_tpu_torch.models.krylov import mg_pcg
    from gnnla_tpu_torch.ops.dia_spmv import DiaKernelOperator
    from gnnla_tpu_torch.utils import program as prog

    mg, b, x0, kw = _sa_solve(cuda, 9)
    op = mg.As[0]
    assert isinstance(op, DiaKernelOperator)
    run = prog.program(mg_pcg)
    with _profiling():
        run(mg, b, x0, **kw)
        run(mg, b, x0, **kw)
        assert (run.captures, run.replays) == (1, 1)
        with torch.no_grad():
            op.diags.mul_(1.0)
        y = run(mg, b, x0, **kw)[0]
        assert (run.captures, run.replays, op.rebuilds) == (2, 1, 1)
        z = run(mg, b, x0, **kw)[0]
        assert run.replays == 2
    want = mg_pcg(mg, b, x0, **kw)[0]
    _close(y, want)
    _close(z, want)


def test_k1_enqueue_is_a_host_span_only_outside_a_capture(cuda):
    """Eager K1 applies while a profiler records add one `k1.launch` call
    each; captured inside a program they record no device span."""
    from gnnla_tpu_torch.utils import program as prog

    _, fast = _fast(64, cuda)
    x = _rand(fast.A.n_rows, 10, cuda)
    prog.reset()
    fast.A.matvec(x)
    assert "k1.launch" not in prog.report()
    run = prog.program(lambda v: fast.A.matvec(v))
    with _profiling():
        for _ in range(3):
            fast.A.matvec(x)
        run(x)
        run(x)
    rep = prog.report()
    # three eager applies and the warm-up's; none from the capture
    assert rep["k1.launch"]["calls"] == 4
    assert rep["k1.launch"]["device_calls"] == 0
