"""K1's Chebyshev form on the CPU: the rule by which `models.chebyshev`
hands a whole recurrence to `DiaKernelOperator.chebyshev`, and the alpha
and beta that the form's launch carries.

The form itself runs only on the card (`tests/test_torch_gpu.py` holds
it to the eager chain bit for bit). Here: every operator and vector the
form does not take keeps the eager chain (CPU tensors, autograd, bf16
storage, a COO `SparseOperator`, rows past one block), with
its bits and no launch, while `CHEB_TALLY` counts the call; the shape
rule (`chebyshev_fits`) at its edges; and the scalars the launch carries
(`chebyshev_scalars`, each cast to f32 by ctypes) are those the eager
chain's products use.
"""

import ctypes
import importlib

import numpy as np
import pytest
import torch

from gnnla_tpu_torch.models import chebyshev
from gnnla_tpu_torch.models.chebyshev import chebyshev_scalars
from gnnla_tpu_torch.ops.dia import to_dia
from gnnla_tpu_torch.ops.dia_spmv import (CHEB_MAX_DEG, CHEB_ROWS,
                                          chebyshev_fits,
                                          dia_kernel_operator, dia_tiles,
                                          dia_tiles_chebyshev_cuda)
from gnnla_tpu_torch.problems import laplacian_2d, laplacian_nd

TALLY = importlib.import_module("gnnla_tpu_torch.models.chebyshev").CHEB_TALLY
CHEB = dict(c=1.9, d=2.1, deg=8)


def vec(n, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(n).astype(np.float32))


def k1(grid, dtype=torch.float32):
    A = laplacian_nd(grid, device="cpu")[0].eliminate_zeros()
    return A, dia_kernel_operator(to_dia(A), diag_dtype=dtype)


@pytest.mark.parametrize("case", ["cpu", "autograd_x", "autograd_b",
                                  "autograd_diags", "bf16", "sparse",
                                  "rows_past_limit"])
def test_what_the_form_does_not_take_keeps_the_eager_chain(case):
    """Each call counts in `calls` and none in `one_launch`; x is the
    eager chain's over the plain operator, and nothing is launched."""
    grid = (CHEB_ROWS + 1,) if case == "rows_past_limit" else (12,)
    A, op = k1(grid, torch.bfloat16 if case == "bf16" else torch.float32)
    b, x = vec(op.n, 1), vec(op.n, 2)
    fits = chebyshev_fits(op.layout(), CHEB["deg"])
    assert fits == (case not in ("bf16", "rows_past_limit"))
    if case == "sparse":
        op = A
        assert not hasattr(op, "takes_chebyshev")
    want = chebyshev(op if case == "sparse" else op.plain(), b, x, **CHEB)
    if case == "autograd_diags":
        op.diags.requires_grad_()
    bb = b.clone().requires_grad_(case == "autograd_b")
    xx = x.clone().requires_grad_(case == "autograd_x")
    if case.startswith("autograd"):
        assert not op.fuses(bb, xx)
    elif case != "sparse":
        assert not op.takes_chebyshev(bb, xx, CHEB["deg"])
    before = (TALLY.calls, TALLY.one_launch)
    got = chebyshev(op, bb, xx, **CHEB)
    assert (TALLY.calls, TALLY.one_launch) == (before[0] + 1, before[1])
    assert got.requires_grad == case.startswith("autograd")
    assert torch.equal(got.detach(), want)
    if case != "sparse":
        assert op.launches == 0


def test_degree_zero_counts_and_returns_x():
    _, op = k1((12,))
    x = vec(op.n, 3)
    before = TALLY.calls
    assert torch.equal(chebyshev(op, vec(op.n, 4), x, c=1.0, d=2.0, deg=0),
                       x)
    assert TALLY.calls == before + 1


def test_the_shape_rule_at_its_edges():
    """One block's rows (128: 4 tiles of 8 warps), f32, the split shape,
    1 <= deg <= CHEB_MAX_DEG."""
    assert CHEB_ROWS == 128
    tiles = k1((CHEB_ROWS,))[1].layout()
    assert chebyshev_fits(tiles, 1) and chebyshev_fits(tiles, CHEB_MAX_DEG)
    assert not chebyshev_fits(tiles, 0)
    assert not chebyshev_fits(tiles, CHEB_MAX_DEG + 1)
    assert not chebyshev_fits(tiles._replace(split=False), 8)
    assert chebyshev_fits(k1((8, 16))[1].layout(), 8)
    assert chebyshev_fits(k1((1,))[1].layout(), 8)
    assert not chebyshev_fits(k1((CHEB_ROWS + 1,))[1].layout(), 8)
    assert not chebyshev_fits(k1((12,), torch.bfloat16)[1].layout(), 8)


@pytest.mark.parametrize("interval", [(1.9, 2.1, 8), (-3.4, -4.0, 4),
                                      (0.4999, 0.5001, CHEB_MAX_DEG),
                                      (3.0, 7.0, 2), (1.0, 3.0, 1)])
def test_the_launch_carries_what_the_eager_chain_hands_pytorch(monkeypatch,
                                                                interval):
    """The Python scalars the eager chain multiplies vectors by (x's
    update by alpha_1; then each step r's by the old alpha, p's by beta,
    x's by the new alpha) are `chebyshev_scalars`' in that order, and
    the f32 each becomes in ctypes (the launch's argument) is the one
    PyTorch's f32 product uses."""
    c, d, deg = interval
    seen = []
    real = torch.Tensor.__rmul__

    def rmul(self, other):
        if isinstance(other, float):
            seen.append(other)
        return real(self, other)

    monkeypatch.setattr(torch.Tensor, "__rmul__", rmul)
    A = laplacian_2d(4, device="cpu").eliminate_zeros()
    chebyshev(to_dia(A), vec(16, 5), vec(16, 6), c=c, d=d, deg=deg)
    monkeypatch.undo()
    assert len(seen) == 1 + 3 * (deg - 1)
    alphas, betas = chebyshev_scalars(c, d, deg)
    assert (len(alphas), len(betas)) == (deg, deg - 1)
    assert seen[:1] + seen[3::3] == alphas
    assert seen[1::3] == alphas[:-1]
    assert seen[2::3] == betas
    one = torch.ones(1)
    for s_ in seen:  # PyTorch's f32 product against the launch's f32
        assert float((s_ * one)[0]) == ctypes.c_float(s_).value


def test_the_launcher_refuses_cpu_tensors_and_shapes_past_the_form():
    tiles = dia_tiles(torch.ones(1, 4), (0,))
    a, bt = chebyshev_scalars(1.0, 2.0, 2)
    with pytest.raises(ValueError, match="not CUDA"):
        dia_tiles_chebyshev_cuda(tiles, torch.zeros(4), torch.zeros(4), a,
                                 bt)
    assert not chebyshev_fits(tiles, CHEB_MAX_DEG + 1)
