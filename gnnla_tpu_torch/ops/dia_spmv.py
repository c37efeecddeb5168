"""Kernel K1, the DIA SpMV — the counterpart of gnnla_tpu/ops/pallas_spmv.py.

`DiaKernelOperator` is the counterpart of `PallasDiaOperator` and of
`PallasDiaSpMV` (`make_dia_spmv_padded`): a DIA operator whose matvec
launches the hand-written CUDA kernel `csrc/dia_spmv.cu` on CUDA tensors,
and runs the plain PyTorch version (`ops/dia.py::dia_matvec`) only when
the tensor it is given lies on the CPU. It satisfies the matvec/diagonal
protocol the solvers consume, so `models.vcycle.setup_with_dia(...,
kernel=True)` and `models.multigrid.setup_with_dia_multigrid(...,
kernel=True)` swap it into a cycle.

The diagonals are stored in f32 or, with `diag_dtype=torch.bfloat16`, in
bf16 (the JAX package's `diag_dtype`): the diagonal stream is the
dominant traffic, and the kernel widens each value to f32 before its
product, so x, y and the sums stay f32.

Differentiable in x and in the diagonals with the JAX package's custom
VJP (`pallas_spmv.py:191-207`): x's cotangent is K1 again on the
transposed diagonals (`ops/dia.py::dia_transpose`, built once at
construction as `PallasDiaSpMV.__init__` builds them), the diagonals'
cotangent ybar[i] * x[i + off_k] in plain array ops (zero where i + off_k
leaves [0, n)), cast to the stored dtype.

The TPU's tile fitting (`fit_dia_tile`) and halo-padded layout have no
counterpart: they exist for the TPU's VMEM. The kernel takes plain [n]
vectors; its bounds guard replaces the halo padding.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gnnla_tpu_torch import _build
from gnnla_tpu_torch.ops.dia import DIAOperator, dia_matvec, dia_transpose

DIAG_DTYPES = (torch.float32, torch.bfloat16)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"dia_spmv: {msg}")


def dia_spmv_cuda(diags: torch.Tensor, offsets: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """Launch K1: y = A x for diags [K, n] f32 or bf16, offsets [K] int32
    and x [n] f32, all contiguous on one CUDA device."""
    _require(x.device.type == "cuda", f"x lies on {x.device}, not CUDA")
    _require(diags.device == x.device and offsets.device == x.device,
             "diags, offsets and x must share one device")
    _require(diags.dtype in DIAG_DTYPES and x.dtype == torch.float32,
             "diags must be float32 or bfloat16 and x float32")
    _require(offsets.dtype == torch.int32, "offsets must be int32")
    _require(diags.ndim == 2 and x.ndim == 1 and offsets.ndim == 1,
             "diags [K, n], offsets [K] and x [n] expected")
    k, n = diags.shape
    _require(offsets.shape[0] == k and x.shape[0] == n,
             f"shapes diags {tuple(diags.shape)}, offsets "
             f"{tuple(offsets.shape)}, x {tuple(x.shape)} disagree")
    _require(k <= 12 * 1024, f"K={k} offsets exceed the 48 KB of shared "
             "memory the kernel stages them in")
    _require(diags.is_contiguous() and x.is_contiguous()
             and offsets.is_contiguous(), "inputs must be contiguous")
    y = torch.empty_like(x)
    lib = _build.load()
    fn, name = ((lib.dia_spmv_f32, "dia_spmv_f32")
                if diags.dtype == torch.float32
                else (lib.dia_spmv_bf16, "dia_spmv_bf16"))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check(fn(diags.data_ptr(), offsets.data_ptr(), k, n,
                        x.data_ptr(), y.data_ptr(), stream), name)
    return y


def diags_cotangent(offsets: Tuple[int, ...], ybar: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """ddiags[k, i] = ybar[i] * x[i + off_k], zero where i + off_k leaves
    [0, n): the cotangent of y = A x in the stored diagonals (f32)."""
    n = x.shape[0]
    out = ybar.new_zeros((len(offsets), n))
    for k, off in enumerate(offsets):
        m = n - abs(off)
        if m > 0:
            lo, src = (0, off) if off > 0 else (-off, 0)
            out[k, lo:lo + m] = ybar[lo:lo + m] * x[src:src + m]
    return out


class _DiaGrad(torch.autograd.Function):
    """y = A(diags) x on K1 with the VJP of the JAX `PallasDiaSpMV.apply`:
    x's cotangent K1 on the transposed diagonals, the diagonals'
    `diags_cotangent`; each only when autograd asks for it."""

    @staticmethod
    def forward(ctx, x, diags, op):
        ctx.op = op
        if ctx.needs_input_grad[1]:
            ctx.save_for_backward(x)
        return op.launch(x, diags)

    @staticmethod
    def backward(ctx, ybar):
        op = ctx.op
        ybar = ybar.contiguous()
        xbar = ddiags = None
        if ctx.needs_input_grad[0]:
            xbar = op.launch_t(ybar)
        if ctx.needs_input_grad[1]:
            x, = ctx.saved_tensors
            ddiags = diags_cotangent(op.offsets, ybar, x).to(op.diags.dtype)
        return xbar, ddiags, None


class DiaKernelOperator:
    """DIA operator on kernel K1 (solver protocol: matvec, diagonal,
    n_rows, shape).

    `launches` counts the kernel launches made through `matvec` and its
    backward (x's cotangent is one more launch, on the transposed
    diagonals); it never moves on the CPU path, which runs the plain
    version. `diag_dtype` (float32 or bfloat16; default: the dtype of
    `diags`) is the storage of the diagonal stream; `diagonal()` stays
    the f32 diagonal given, as the JAX operator's `diag` leaf does."""

    def __init__(self, diags: torch.Tensor, offsets: Tuple[int, ...],
                 n: int, nnz: int, diag_dtype=None):
        diag_dtype = diag_dtype or diags.dtype
        if diag_dtype not in DIAG_DTYPES:
            raise ValueError(f"dia_spmv: diag_dtype {diag_dtype} is not one "
                             "of float32, bfloat16")
        self.offsets = tuple(int(o) for o in offsets)
        k0 = self.offsets.index(0)
        # a copy: a view would keep the whole f32 source array alive
        self._diag = (None if diags.dtype == diag_dtype == torch.float32
                      else diags[k0].detach().to(torch.float32, copy=True))
        self.diags = diags.to(diag_dtype).contiguous()
        self.offsets_dev = torch.tensor(self.offsets, dtype=torch.int32,
                                        device=diags.device)
        self.n = int(n)
        self.nnz = int(nnz)
        self.launches = 0
        self._transpose()

    @property
    def n_rows(self) -> int:
        return self.n

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    def plain(self) -> DIAOperator:
        """The same operator on the plain PyTorch path (shares tensors)."""
        return DIAOperator(self.diags, self.offsets, self.n, self.nnz)

    def _transpose(self) -> DIAOperator:
        """A^T's diagonals, built from the stored ones (exact shifts) at
        construction and again only if the diagonals were replaced or
        updated in place since."""
        key = (self.diags.data_ptr(), self.diags._version)
        if getattr(self, "_t_key", None) != key:
            with torch.no_grad():
                t = dia_transpose(self.plain())
            self.transposed = t
            self.offsets_t_dev = torch.tensor(t.offsets, dtype=torch.int32,
                                              device=t.diags.device)
            self._t_key = key
        return self.transposed

    def launch(self, x: torch.Tensor, diags: torch.Tensor) -> torch.Tensor:
        """y = A(diags) x with no autograd: K1 on a CUDA tensor (counted),
        the plain version on a CPU tensor."""
        if x.device.type == "cpu":
            return dia_matvec(diags, self.offsets, x)
        y = dia_spmv_cuda(diags, self.offsets_dev, x)
        self.launches += 1
        return y

    def launch_t(self, ybar: torch.Tensor) -> torch.Tensor:
        """A^T ybar: K1 on the transposed diagonals (counted) on a CUDA
        tensor, the plain version on a CPU tensor."""
        t = self._transpose()
        if ybar.device.type == "cpu":
            return dia_matvec(t.diags, t.offsets, ybar)
        y = dia_spmv_cuda(t.diags, self.offsets_t_dev, ybar)
        self.launches += 1
        return y

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim > 1:
            raise ValueError("DiaKernelOperator matvec is vector-only")
        if torch.is_grad_enabled() and (x.requires_grad
                                        or self.diags.requires_grad):
            return _DiaGrad.apply(x, self.diags, self)
        return self.launch(x, self.diags)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x)

    def diagonal(self) -> torch.Tensor:
        if self._diag is not None:
            return self._diag
        return self.diags[self.offsets.index(0)]


def dia_kernel_operator(dia: DIAOperator,
                        diag_dtype=None) -> DiaKernelOperator:
    """Wrap a DIAOperator in kernel K1 (solver protocol), with the
    diagonals stored in `diag_dtype` (float32 or bfloat16). The port's
    counterpart of both `pallas_dia_operator` and `make_dia_spmv_padded(
    dia, diag_dtype=...)`: with no padded layout the two are one."""
    return DiaKernelOperator(dia.diags, dia.offsets, dia.n, dia.nnz,
                             diag_dtype)
