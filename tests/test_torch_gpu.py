"""Kernels K1 and K2 against their plain PyTorch versions on the card.

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
