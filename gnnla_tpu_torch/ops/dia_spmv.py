"""Kernel K1, the DIA SpMV — the counterpart of gnnla_tpu/ops/pallas_spmv.py.

`DiaKernelOperator` is the counterpart of `PallasDiaOperator`: a DIA
operator whose matvec launches the hand-written CUDA kernel
`csrc/dia_spmv.cu` on CUDA tensors, and runs the plain PyTorch version
(`ops/dia.py::dia_matvec`) only when the tensor it is given lies on the
CPU. It satisfies the matvec/diagonal protocol the solvers consume, so
`models.vcycle.setup_with_dia(..., kernel=True)` swaps it into a cycle.

The TPU's tile fitting (`fit_dia_tile`) has no counterpart: it exists for
the TPU's VMEM limit. The kernel takes plain [n] vectors; its bounds guard
replaces the halo padding.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gnnla_tpu_torch import _build
from gnnla_tpu_torch.ops.dia import DIAOperator, dia_matvec


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"dia_spmv: {msg}")


def dia_spmv_cuda(diags: torch.Tensor, offsets: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """Launch K1: y = A x for diags [K, n] f32, offsets [K] int32 and
    x [n] f32, all contiguous on one CUDA device."""
    _require(x.device.type == "cuda", f"x lies on {x.device}, not CUDA")
    _require(diags.device == x.device and offsets.device == x.device,
             "diags, offsets and x must share one device")
    _require(diags.dtype == torch.float32 and x.dtype == torch.float32,
             "diags and x must be float32")
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
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check(lib.dia_spmv_f32(diags.data_ptr(), offsets.data_ptr(),
                                      k, n, x.data_ptr(), y.data_ptr(),
                                      stream), "dia_spmv_f32")
    return y


class DiaKernelOperator:
    """DIA operator on kernel K1 (solver protocol: matvec, diagonal,
    n_rows, shape).

    `launches` counts the kernel launches made through `matvec`; it never
    moves on the CPU path, which runs the plain version. An x or diags
    that requires grad is refused (NotImplementedError) on the CPU and the
    card alike, until K1's backward is ported: no path returns a result
    whose gradient the other path would cut."""

    def __init__(self, diags: torch.Tensor, offsets: Tuple[int, ...],
                 n: int, nnz: int):
        self.diags = diags.contiguous()
        self.offsets = tuple(int(o) for o in offsets)
        self.offsets_dev = torch.tensor(self.offsets, dtype=torch.int32,
                                        device=diags.device)
        self.n = int(n)
        self.nnz = int(nnz)
        self.launches = 0

    @property
    def n_rows(self) -> int:
        return self.n

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    def plain(self) -> DIAOperator:
        """The same operator on the plain PyTorch path (shares tensors)."""
        return DIAOperator(self.diags, self.offsets, self.n, self.nnz)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if x.requires_grad or self.diags.requires_grad:
            raise NotImplementedError(
                "the gradient of the DIA kernel (the JAX package's custom "
                "VJP) is not ported yet")
        if x.ndim > 1:
            raise ValueError("DiaKernelOperator matvec is vector-only")
        if x.device.type == "cpu":
            return dia_matvec(self.diags, self.offsets, x)
        y = dia_spmv_cuda(self.diags, self.offsets_dev, x)
        self.launches += 1
        return y

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x)

    def diagonal(self) -> torch.Tensor:
        return self.diags[self.offsets.index(0)]


def dia_kernel_operator(dia: DIAOperator) -> DiaKernelOperator:
    """Wrap a DIAOperator in kernel K1 (solver protocol)."""
    return DiaKernelOperator(dia.diags, dia.offsets, dia.n, dia.nnz)
