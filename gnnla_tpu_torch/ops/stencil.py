"""Grid-stencil layout and the plain version of kernel K4 — the host half
of gnnla_tpu/ops/pallas_stencil.py.

Every matrix family of the reference lives on a 2-D grid, so each nonzero
A[i, j] joins grid points (r, c) -> (rj, cj) with a modular shift class

    dy = (rj - r) mod H,   dx = (cj - c) mod W.

Grouping the nonzeros by class turns y = A x into a stencil of K tap planes

    y[r, c] = sum_k  tap_k[r, c] * x[(r + dy_k) % H, (c + dx_k) % W],

exact for any square operator on the grid: Dirichlet truncation leaves
plane entries zero, periodic wrap edges fall into their interior
siblings' class.

  * `stencil_classes`, `stencil_taps` — the host layout, identical shift
    lists and float64 planes to the JAX package's.
  * `stencil_apply_plain` — K4's plain PyTorch version in its three modes
    (the jnp twin `stencil_matvec_jnp` iterated, with the kernel's affine
    and normalize epilogues). The CUDA kernel is `ops/stencil_kernel.py`.
  * `stencil_matvec`, `stencil_transpose` — the differentiable roll
    matvec the trainer's stencil loss layout runs (batched too), and A^T's
    taps from A's.

The TPU's VMEM guard (`_vmem_budget`, `_vmem_check`) has no counterpart:
it is the TPU's limit, not the algorithm's. `MAX_TAPS` is semantic (a
pattern with more classes is not a stencil) and stays.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

MAX_TAPS = 64
MODES = ("plain", "affine", "normalize")


def stencil_classes(rows, cols, h: int, w: int):
    """Modular shift classes of a COO pattern on an h x w grid.

    Returns (shifts, k_idx): shifts the sorted list of (dy, dx) classes,
    k_idx the class index of each nonzero (aligned with `rows`/`cols`).
    Raises ValueError above MAX_TAPS classes."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    r, c = rows // w, rows % w
    rj, cj = cols // w, cols % w
    dy = (rj - r) % h
    dx = (cj - c) % w
    cls = dy * w + dx
    uniq, k_idx = np.unique(cls, return_inverse=True)
    if uniq.size > MAX_TAPS:
        raise ValueError(
            f"pattern has {uniq.size} (dy, dx) shift classes "
            f"(> {MAX_TAPS}); not a stencil on a {h}x{w} grid")
    shifts = [(int(u) // w, int(u) % w) for u in uniq]
    return shifts, k_idx


def stencil_taps(op, grid_shape: Tuple[int, int]):
    """Group the nonzeros of a grid operator by modular shift class.

    Returns (shifts, planes): shifts a list of (dy, dx) with 0 <= dy < H,
    0 <= dx < W; planes a float64 [K, H*W] array with
    planes[k, r*W + c] = A[(r, c), ((r+dy_k)%H, (c+dx_k)%W)]."""
    h, w = grid_shape
    if op.shape[0] != op.shape[1] or op.shape[0] != h * w:
        raise ValueError(f"grid {h}x{w} needs a square {h * w}-row "
                         f"operator, got {op.shape}")
    rows, cols, vals = op.host_coo()
    shifts, k_idx = stencil_classes(rows, cols, h, w)
    planes = np.zeros((len(shifts), h * w), np.float64)
    np.add.at(planes, (k_idx, rows), vals)
    return shifts, planes


def stencil_transpose(shifts: Sequence[Tuple[int, int]],
                      planes: torch.Tensor):
    """Tap planes of A^T from those of A (differentiable).

    A^T's class for A's (dy, dx) is ((-dy) % H, (-dx) % W), and its plane
    is A's plane moved to the target points: a (dy, dx) roll.
    planes [K, H, W]; returns (shifts_t, planes_t)."""
    h, w = planes.shape[1], planes.shape[2]
    shifts_t = [((-dy) % h, (-dx) % w) for dy, dx in shifts]
    planes_t = torch.stack([torch.roll(planes[k], (dy, dx), (0, 1))
                            for k, (dy, dx) in enumerate(shifts)])
    return shifts_t, planes_t


def stencil_matvec(planes: torch.Tensor, shifts: Sequence[Tuple[int, int]],
                   x: torch.Tensor) -> torch.Tensor:
    """y = A x as rolls, differentiable in planes and x — the twin of the
    JAX package's `stencil_matvec_jnp`, the matvec of the stencil loss
    layout (not kernel K4):

        y[r, c] = sum_k planes[k, r, c] * x[(r + dy_k) % H, (c + dx_k) % W]

    planes [K, H, W] with x [H, W] or [H, W, m]; or a batch, planes
    [B, K, H, W] with x [B, H, W] or [B, H, W, m]."""
    nb = planes.ndim - 3  # batch dims
    if x.ndim not in (nb + 2, nb + 3):
        raise ValueError(f"x {tuple(x.shape)} does not fit planes "
                         f"{tuple(planes.shape)}")
    acc = None
    for k, (dy, dx) in enumerate(shifts):
        p = planes[..., k, :, :]
        if x.ndim == nb + 3:
            p = p[..., None]
        term = p * torch.roll(x, (-dy, -dx), (nb, nb + 1))
        acc = term if acc is None else acc + term
    return acc


def check_mode(mode: str, c: Optional[torch.Tensor]) -> None:
    if mode not in MODES:
        raise ValueError(f"stencil mode must be one of {MODES}, got {mode!r}")
    if (mode == "affine") != (c is not None):
        raise ValueError("the affine mode takes c; the other modes do not")


def stencil_apply_plain(taps: torch.Tensor, shifts: Sequence[Tuple[int, int]],
                        x2d: torch.Tensor, n_steps: int, mode: str,
                        c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4's plain version: n_steps of

        plain:      x <- T x
        affine:     x <- T x + c
        normalize:  x <- T x / ||T x||_2   (norm over the whole grid)

    with (T x)[r, c] = sum_k taps[k, r, c] * x[(r+dy_k)%H, (c+dx_k)%W],
    summed in shift order from tap_0 * v_0, in f32 (bf16 taps are
    widened exactly). taps [K, H, W], x2d and c [H, W]."""
    check_mode(mode, c)
    x = x2d.float()
    for _ in range(n_steps):
        acc = None
        for k, (dy, dx) in enumerate(shifts):
            term = taps[k].float() * torch.roll(x, (-dy, -dx), (0, 1))
            acc = term if acc is None else acc + term
        if mode == "affine":
            acc = acc + c
        elif mode == "normalize":
            acc = acc * torch.rsqrt(torch.sum(acc * acc))
        x = acc
    return x
