"""Kernel K9, the stage ablation of K2 — the counterpart of
scratch/ablate_stream.py, which timed the TPU stream SpMV with its stages
removed one at a time (`make_call(variant)`).

K9 is K2's kernel body (`csrc/csr_spmv_body.cuh`) compiled once per
variant with compile-time stage flags (`csrc/csr_ablate.cu`), launched on
a K2 operator's own CSR and row blocks. The variants keep the TPU's names;
on the card the TPU's stages map to K2's as:

  * gather  -> the x loads (without it a term is v + x[0], :81-82);
  * scan    -> each row's sum (without it a row keeps its first product);
  * deposit -> the products' round trip through shared memory (without
               it each row's thread reads its own nonzeros: the walk);
  * matmul  -> the TPU's one-hot MXU accumulation, which K2 has no
               counterpart of: "nomatmul" is K2 unchanged.

`full` is K2, bit for bit; `minimal` removes gather, deposit and scan:
each thread sums the terms v + x[0] of the nonzeros it stages and writes
the sum to the row of its own index. Each variant's plain version
(`ablate_plain`) defines what the variant computes, and the kernel equals
it bit for bit.
"""

from __future__ import annotations

import torch

from gnnla_tpu_torch import _build
from gnnla_tpu_torch.ops.stream_spmv import (BLOCK_NNZ, BLOCK_ROWS,
                                             LONG_ROW, CsrSpMV, entry_rows)

VARIANTS = ("full", "nomatmul", "nogather", "noscan", "nodeposit",
            "minimal")
# the stages each variant keeps: (gather, deposit, scan)
STAGES = {"full": (True, True, True), "nomatmul": (True, True, True),
          "nogather": (False, True, True), "noscan": (True, True, False),
          "nodeposit": (True, False, True),
          "minimal": (False, False, False)}


def csr_order_sum(row_ptr: torch.Tensor, terms: torch.Tensor,
                  n_rows: int) -> torch.Tensor:
    """y[r] = the row's terms added in CSR order from 0, one f32 add at a
    time (K2's order on rows of at most LONG_ROW nonzeros)."""
    lens = row_ptr.diff().long()
    width = int(lens.max()) if n_rows else 0
    steps = torch.arange(width, device=terms.device)
    live = steps[None, :] < lens[:, None]
    pos = torch.where(live, row_ptr[:-1].long()[:, None] + steps, 0)
    t = terms[pos]
    acc = terms.new_zeros(n_rows)
    for p in range(width):
        acc = torch.where(live[:, p], acc + t[:, p], acc)
    return acc


def _thread_sums(row_ptr: torch.Tensor, row_blocks: torch.Tensor,
                 terms: torch.Tensor, n_rows: int) -> torch.Tensor:
    """`minimal`'s y: thread t of a row block stages the aligned groups of
    4 nonzeros (p0 >> 2) + t + 256 i, i = 0, 1, ..., of the block's range
    [p0, p1), adds their terms in that order from 0, and writes the sum to
    row r0 + t when the block has that row."""
    dev = terms.device
    nnz = terms.shape[0]
    rows = entry_rows(row_ptr, nnz)
    blocks = row_blocks.long()
    b = torch.searchsorted(blocks, rows, right=True) - 1
    r0 = blocks[b]
    p = torch.arange(nnz, device=dev)
    gi = (p >> 2) - (row_ptr.long()[r0] >> 2)
    target = r0 + gi % BLOCK_ROWS
    pos = (gi // BLOCK_ROWS) * 4 + (p & 3)
    keep = target < blocks[b + 1]
    width = int(pos.max()) + 1 if nnz else 0
    dense = terms.new_zeros((n_rows, width))
    live = torch.zeros((n_rows, width), dtype=torch.bool, device=dev)
    dense[target[keep], pos[keep]] = terms[keep]
    live[target[keep], pos[keep]] = True
    acc = terms.new_zeros(n_rows)
    for j in range(width):
        acc = torch.where(live[:, j], acc + dense[:, j], acc)
    return acc


def ablate_plain(variant: str, row_ptr: torch.Tensor, cols: torch.Tensor,
                 vals: torch.Tensor, row_blocks: torch.Tensor,
                 x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """What `variant` computes on a CSR whose rows hold at most LONG_ROW
    nonzeros, with its row blocks (`csr_row_blocks`)."""
    gather, deposit, scan = STAGES[variant]
    terms = vals * x[cols.long()] if gather else vals + x[0]
    if scan:
        return csr_order_sum(row_ptr, terms, n_rows)
    if deposit:  # noscan: a row's first product
        lens = row_ptr.diff()
        first = terms[row_ptr[:-1].long().clamp_max(max(terms.shape[0] - 1,
                                                        0))]
        return torch.where(lens > 0, first, torch.zeros_like(first))
    return _thread_sums(row_ptr, row_blocks, terms, n_rows)


class StreamAblation:
    """K9 on a K2 operator (a CsrSpMV): `__call__(variant, x)` launches the
    variant on a CUDA tensor (counted in `launches[variant]`) and runs
    its plain version on a CPU tensor. Refuses rows longer than LONG_ROW,
    which K2 sums with a warp or a whole block in every variant."""

    def __init__(self, csr: CsrSpMV):
        lens = csr.row_ptr.diff()
        if csr.nnz and int(lens.max()) > LONG_ROW:
            raise ValueError(f"stream_ablate: rows longer than {LONG_ROW} "
                             "nonzeros are summed by a warp or a whole block "
                             "in every variant; the ablation takes short "
                             "rows only")
        spans = csr.row_ptr.long()[csr.row_blocks.long()].diff()
        if csr.nnz and int(spans.max()) > BLOCK_NNZ:
            raise ValueError("stream_ablate: a row block holds more than "
                             f"{BLOCK_NNZ} nonzeros")
        self.csr = csr
        self.launches = {v: 0 for v in VARIANTS}

    def plain(self, variant: str, x: torch.Tensor) -> torch.Tensor:
        c = self.csr
        return ablate_plain(variant, c.row_ptr, c.cols, c.vals,
                            c.row_blocks, x, c.shape[0])

    def raw(self, variant: str, x: torch.Tensor) -> torch.Tensor:
        """The variant's launch on x, uncounted."""
        c = self.csr
        if x.device.type != "cuda" or x.device != c.vals.device:
            raise ValueError(f"stream_ablate: x lies on {x.device}, not on "
                             f"the operator's CUDA device {c.vals.device}")
        if (x.dtype != torch.float32 or not x.is_contiguous()
                or x.shape != (c.shape[1],)):
            raise ValueError(f"stream_ablate: x must be contiguous float32 "
                             f"[{c.shape[1]}], not {tuple(x.shape)}")
        y = x.new_empty(c.shape[0])
        lib = _build.load()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            _build.check(lib.csr_ablate_f32(
                VARIANTS.index(variant), c.row_ptr.data_ptr(),
                c.cols.data_ptr(), c.vals.data_ptr(), c.shape[0],
                c.row_blocks.data_ptr(), c.row_blocks.shape[0] - 1, c.nnz,
                x.data_ptr(), y.data_ptr(), stream), "csr_ablate_f32")
        return y

    def __call__(self, variant: str, x: torch.Tensor) -> torch.Tensor:
        if variant not in STAGES:
            raise ValueError(f"stream_ablate: variant {variant!r} is none "
                             f"of {VARIANTS}")
        if x.device.type == "cpu":
            return self.plain(variant, x)
        y = self.raw(variant, x)
        self.launches[variant] += 1
        return y


def variant_bytes(csr: CsrSpMV, variant: str) -> int:
    """The bytes `variant` must move (each input read once, y written
    once): K2's for the variants that read every nonzero and x; without
    the gather x[0] alone."""
    gather, _, _ = STAGES[variant]
    r_, c_ = csr.shape
    x_bytes = c_ * 4 if gather else 4
    return (csr.nnz * 8 + (r_ + 1) * 4 + csr.row_blocks.shape[0] * 4
            + x_bytes + r_ * 4)

