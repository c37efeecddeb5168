"""BSR (block-sparse row) format — the PyTorch counterpart of
gnnla_tpu/ops/bsr.py.

The operator is cut into B x B dense blocks and only the nonempty ones are
kept; the SpMV becomes

    gather x tiles  ->  batched dense block product  ->  segment-sum tiles

Storage and traffic are nb * B^2 words, so its efficiency is the block
density. The JAX package computes the block product with one einsum
outside any Pallas kernel; here it is `torch.bmm` (in full f32: the
caller keeps TF32 off) and the segment sum is `ops/segment.py`'s
`index_add_`, whose atomics sum in another order than
jax.ops.segment_sum, so results agree to rounding, not bitwise.

Ordering matters: BSR rewards locality. Use bandwidth-reducing orderings
(reverse Cuthill-McKee, `rcm_permutation`) to raise block density.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.ops.segment import segment_sum
from gnnla_tpu_torch.ops.sparse import SparseOperator


class BSROperator:
    """Square block-sparse operator on one device.

    blocks     : [nb, B, B] dense blocks (block k is A[block_rows[k]*B :,
                 block_cols[k]*B :])
    block_rows : [nb] int64, sorted
    block_cols : [nb] int64
    """

    def __init__(self, blocks: torch.Tensor, block_rows: torch.Tensor,
                 block_cols: torch.Tensor, n: int, block_size: int,
                 nnz: int = 0):
        self.blocks = blocks
        self.block_rows = block_rows
        self.block_cols = block_cols
        self.n = int(n)
        self.block_size = int(block_size)
        self.nnz = int(nnz)

    @property
    def n_block_rows(self) -> int:
        return -(-self.n // self.block_size)

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x for x of shape [n] or [n, m]: x's tiles gathered per
        block, one batched block product, a segment sum per block row."""
        if x.shape[0] != self.n:
            raise ValueError(f"matvec: x has {x.shape[0]} rows, operator "
                             f"expects {self.n}")
        B, nbr = self.block_size, self.n_block_rows
        vec = x.ndim == 1
        x2 = x[:, None] if vec else x
        x2 = torch.nn.functional.pad(x2, (0, 0, 0, nbr * B - self.n))
        xt = x2.reshape(nbr, B, -1)                           # [nbr, B, m]
        gathered = xt.index_select(0, self.block_cols)        # [nb, B, m]
        prod = torch.bmm(self.blocks, gathered)
        y = segment_sum(prod, self.block_rows, nbr)
        y = y.reshape(nbr * B, -1)[: self.n]
        return y[:, 0] if vec else y

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x)

    def diagonal(self) -> torch.Tensor:
        """diag(A) assembled from the diagonal blocks."""
        is_diag = self.block_rows == self.block_cols
        contrib = torch.where(
            is_diag[:, None],
            torch.diagonal(self.blocks, dim1=1, dim2=2),
            torch.zeros((), dtype=self.blocks.dtype, device=self.device))
        out = segment_sum(contrib, self.block_rows, self.n_block_rows)
        return out.reshape(-1)[: self.n]


def to_bsr(op: SparseOperator, block_size: int = 128,
           max_blocks: int = 1 << 22, device=None) -> BSROperator:
    """Convert to BSR on `device` (default: the operator's). The pattern is
    counted on the host first; raises when it needs more than `max_blocks`
    blocks (block density too low for BSR to pay off — stay on COO or
    reorder first), before anything is allocated.

    The blocks are those of the JAX package bit for bit: each nonzero goes
    to its own slot, in f32 (entries that share a slot — duplicates of an
    uncoalesced operator — are first summed in float64 in their order, as
    the JAX package's np.add.at sums them)."""
    if op.shape[0] != op.shape[1]:
        raise ValueError("BSR requires a square operator")
    dev = op.device if device is None else resolve_device(device)
    n, B = op.shape[0], block_size
    nbc = -(-n // B)
    rows, cols, vals = op.host_coo()
    uniq, inv = np.unique((rows // B) * nbc + cols // B, return_inverse=True)
    nb = uniq.size
    if nb > max_blocks:
        raise ValueError(f"pattern needs {nb} blocks (> {max_blocks})")
    slot = (inv.reshape(-1) * B + rows % B) * B + cols % B
    if slot.size > 1 and not (np.diff(rows * n + cols) > 0).all():
        slot, sinv = np.unique(slot, return_inverse=True)
        vals = np.bincount(sinv.reshape(-1), weights=vals,
                           minlength=slot.size)
    blocks = torch.zeros(nb * B * B, dtype=op.vals.dtype, device=dev)
    blocks[torch.from_numpy(slot).to(dev)] = torch.from_numpy(
        np.asarray(vals, np.float64)).to(op.vals.dtype).to(dev)
    return BSROperator(
        blocks=blocks.reshape(nb, B, B),
        block_rows=torch.from_numpy(uniq // nbc).to(dev),
        block_cols=torch.from_numpy(uniq % nbc).to(dev),
        n=n, block_size=B, nnz=op.nnz)


def rcm_permutation(op: SparseOperator) -> np.ndarray:
    """Reverse Cuthill-McKee ordering (host, scipy) — apply before `to_bsr`
    on arbitrary graphs to concentrate nonzeros near the diagonal."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    return np.asarray(reverse_cuthill_mckee(op.to_scipy(),
                                            symmetric_mode=False))


def permute(op: SparseOperator, perm: np.ndarray
            ) -> Tuple[SparseOperator, np.ndarray]:
    """(P A P^T, inverse permutation) for a symmetric reordering: entry
    (i, j) moves to (inv[i], inv[j]); x/b vectors reorder as x[perm]."""
    rows, cols, vals = op.host_coo()
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    out = SparseOperator.from_coo(inv[rows], inv[cols], vals, op.shape,
                                  dtype=op.vals.dtype, device=op.device)
    return out, inv
