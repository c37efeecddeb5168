"""K1's vertex-update forms on the CPU: `DiaKernelOperator.jacobi_sweep`
and `.residual`, and the dispatch of `models.jacobi` and
`models.residual` to them.

On CPU tensors the forms run the eager chain, so `jacobi` and `residual`
on a K1 operator must give the bits of the chain written out here over
the plain DIA operator, with the default and with a trained diagonal, f32
and bf16 storage. Where autograd needs the sweep, the dispatch keeps the
eager path: no fused call, and x's gradient that of the plain operator.
The card's kernels are held to the same chain bit for bit in
`tests/test_torch_gpu.py`.
"""

import numpy as np
import pytest
import torch

from gnnla_tpu_torch.models import jacobi, residual
from gnnla_tpu_torch.ops.dia import to_dia
from gnnla_tpu_torch.ops.dia_spmv import (DiaKernelOperator,
                                          dia_kernel_operator)
from gnnla_tpu_torch.problems import laplacian_2d

OMEGA = 0.7


def kernel_operator(dtype):
    A = laplacian_2d(20, device="cpu").eliminate_zeros()
    return dia_kernel_operator(to_dia(A), diag_dtype=dtype)


def vec(n, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(n).astype(np.float32))


def eager_jacobi(op, b, x, n_iters, d):
    """jacobi's eager path over the plain operator: w once, then the
    SpMV, b - y, w * r and x + t each sweep."""
    w = OMEGA / d
    for _ in range(n_iters):
        x = x + w * (b - op.plain().matvec(x))
    return x


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts of the calls of each fused form."""
    calls = {"jacobi_sweep": 0, "residual": 0}
    for name in calls:
        real = getattr(DiaKernelOperator, name)

        def counted(self, *args, _real=real, _name=name):
            calls[_name] += 1
            return _real(self, *args)
        monkeypatch.setattr(DiaKernelOperator, name, counted)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("trained", [False, True], ids=["diag", "trained"])
@pytest.mark.parametrize("n_iters", [1, 2, 3])
def test_fused_forms_give_the_eager_bits(n_iters, trained, dtype,
                                         fused_calls):
    op = kernel_operator(dtype)
    b, x = vec(op.n, 1), vec(op.n, 2)
    d = (op.diagonal() * (1.0 + 0.3 * vec(op.n, 3).abs()) if trained
         else None)
    got = jacobi(op, b, x, omega=OMEGA, n_iters=n_iters, diag=d)
    want = eager_jacobi(op, b, x, n_iters,
                        op.diagonal() if d is None else d)
    assert torch.equal(got, want)
    assert torch.equal(residual(op, b, x), b - op.plain().matvec(x))
    assert fused_calls == {"jacobi_sweep": n_iters, "residual": 1}
    # the CPU runs the plain version: nothing is launched
    assert op.launches == op.fused_launches == 0


@pytest.mark.parametrize("needs", ["x", "b", "diags"])
def test_autograd_keeps_the_eager_path(needs, fused_calls):
    """A sweep or residual that autograd must differentiate takes the
    eager path (no fused call); x's gradient is the plain operator's."""
    op = kernel_operator(torch.float32)
    b, x0 = vec(op.n, 4), vec(op.n, 5)
    x = x0.clone().requires_grad_(needs == "x")
    bb = b.clone().requires_grad_(needs == "b")
    if needs == "diags":
        op.diags.requires_grad_()
    y = jacobi(op, bb, x, omega=OMEGA, n_iters=2)
    r = residual(op, bb, y)
    assert fused_calls == {"jacobi_sweep": 0, "residual": 0}
    assert r.requires_grad
    with torch.no_grad():
        assert torch.equal(y, eager_jacobi(op, b, x0, 2, op.diagonal()))
    if needs != "x":
        return
    r.square().sum().backward()
    xp = x0.clone().requires_grad_()
    plain = op.plain()
    residual(plain, b, jacobi(plain, b, xp, omega=OMEGA,
                              n_iters=2)).square().sum().backward()
    torch.testing.assert_close(x.grad, xp.grad)


def test_no_grad_fuses_under_grad_mode_off(fused_calls):
    """With autograd off, even a tensor that requires grad takes the fused
    form: nothing would be recorded."""
    op = kernel_operator(torch.float32)
    b, x = vec(op.n, 6), vec(op.n, 7).requires_grad_()
    with torch.no_grad():
        got = jacobi(op, b, x, omega=OMEGA, n_iters=1)
        assert torch.equal(got, eager_jacobi(op, b, x, 1, op.diagonal()))
    assert fused_calls["jacobi_sweep"] == 1


def test_other_vectors_keep_the_eager_path(fused_calls):
    """float64 vectors take the eager path (its dtype), and a batch of
    vectors the matvec's refusal, as before the fused forms."""
    op = kernel_operator(torch.float32)
    b = vec(op.n, 8).double()
    x = torch.zeros(op.n, dtype=torch.float64)
    assert residual(op, b, x).dtype == torch.float64
    with pytest.raises(ValueError, match="vector-only"):
        residual(op, torch.zeros(op.n, 2), torch.zeros(op.n, 2))
    assert fused_calls["residual"] == 0
