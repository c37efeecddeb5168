"""Kernels K1, K2 and K4 against their plain PyTorch versions on the card.

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
    from gnnla_tpu_torch.ops.dia_spmv import dia_spmv_cuda
    from gnnla_tpu_torch.ops.stream_spmv import csr_spmv_cuda

    diags = torch.ones(1, 8, device=cuda)
    offs = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        dia_spmv_cuda(diags, offs, torch.ones(8, device=cuda,
                                              dtype=torch.float64))
    with pytest.raises(ValueError, match="int32"):
        dia_spmv_cuda(diags, offs.long(), torch.ones(8, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        dia_spmv_cuda(diags, offs, torch.ones(16, device=cuda)[::2])
    with pytest.raises(ValueError, match="disagree"):
        dia_spmv_cuda(diags, offs, torch.ones(9, device=cuda))
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
    assert call.launches == stencil_launches(mode, n_steps)
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
    assert sum(c.launches for c in g.kernel_calls()) == 33


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
        with pytest.raises(NotImplementedError, match="training slice"):
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
