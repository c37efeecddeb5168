"""Kernel K1, the DIA SpMV — the counterpart of gnnla_tpu/ops/pallas_spmv.py.

`DiaKernelOperator` is the counterpart of `PallasDiaOperator` and of
`PallasDiaSpMV` (`make_dia_spmv_padded`): a DIA operator whose matvec
launches the hand-written CUDA kernel `csrc/dia_spmv.cu` on CUDA tensors,
and runs the plain PyTorch version (`ops/dia.py::dia_matvec`) only when
the tensor it is given lies on the CPU. It satisfies the matvec/diagonal
protocol the solvers consume, so `models.vcycle.setup_with_dia(...,
kernel=True)` and `models.multigrid.setup_with_dia_multigrid(...,
kernel=True)` swap it into a cycle.

The kernel reads a tile-compressed copy of the diagonals (`dia_tiles`):
for each tile of 32 rows only the diagonals with a nonzero value in those
rows, as segments of 32 values. A Galerkin coarse operator's band is
mostly structural zeros (the fast setup's Ac keeps 2% of its dense
diagonal array), and the kernel streams only what the tiles hold. The
dense `diags` stay the operator's parameter, the plain version's storage
and the gradient's shape; the compact copy of A is built from them at
construction, that of A^T at its first use (an operator only applied
forward, as a coarse operator in a cycle, never builds it), and both
again only when the diagonals were replaced or changed in place (counted
in `rebuilds`), never inside a cycle that leaves them alone. The dense diagonals may stay on the host while the layouts, the
f32 main diagonal and the launches are on the card (`device`): the card
then holds no dense band, which for the two-grid Ac at 1024^2 (415
diagonals) is 1.06 GB against a 50 MB layout. The plain version then runs
on the host, and a gradient in the diagonals needs them on the card.

The diagonals are stored in f32 or, with `diag_dtype=torch.bfloat16`, in
bf16 (the JAX package's `diag_dtype`): the kernel widens each value to
f32 before its product, so x, y and the sums stay f32.

Differentiable in x and in the diagonals with the JAX package's custom
VJP (`pallas_spmv.py:191-207`): x's cotangent is K1 again on the compact
layout of the transposed diagonals (`ops/dia.py::dia_transpose`, built at
its first use; `PallasDiaSpMV.__init__` builds them at construction), the
diagonals' cotangent ybar[i] * x[i + off_k] in plain array ops over the
whole [K, n] band (zero where i + off_k leaves [0, n)), cast to the
stored dtype.

Non-finite x gives the reference's result: the reference multiplies every
stored diagonal, zeros included, so a row that reaches an inf or NaN of x
only through a skipped (tile, diagonal) segment is NaN there too. The
kernel finds such x on the fly and its last block repairs those rows
(`csrc/dia_spmv.cu`); for that the layout keeps the operator's dense
offsets and a small int32 `state` (flag, ticket) that each launch leaves
zeroed. So one layout must not run on two CUDA streams at once. A layout
that skips no segment a row reaches in range (`DiaTiles.repair` False,
as the Laplacian's) can need no repair, and its launches take no ticket.

Given b (and d), the same launch applies a multigrid level's vertex
update to each row's sum (`DiaKernelOperator.jacobi_sweep`, a Jacobi sweep
x + (omega / d)(b - A x), and `.residual`, b - A x; see
`csrc/dia_spmv.cu`): the passes over n-vectors that PyTorch would run after
the SpMV, one kernel each, go. These forms round each step as the eager
chain does, so they give its bits. They have no backward: `jacobi` and
`residual` (`models/`) take them only when autograd needs nothing of the
sweep (`DiaKernelOperator.fuses`).

The TPU's tile fitting (`fit_dia_tile`) and halo-padded layout have no
counterpart: they exist for the TPU's VMEM. The kernel takes plain [n]
vectors; its bounds guard replaces the halo padding.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.autograd import profiler as _profiler

from gnnla_tpu_torch import _build
from gnnla_tpu_torch.ops.dia import (DIAOperator, dia_matvec, dia_transpose,
                                     to_dia)
from gnnla_tpu_torch.ops.sparse import SparseOperator
from gnnla_tpu_torch.utils.program import count, guard, span_begin, span_end

DIAG_DTYPES = (torch.float32, torch.bfloat16)
TILE = 32  # rows per tile: a warp's rows (csrc/dia_spmv.cu kTile)
# below this many tiles (4 warps for each of an H100's 132 SMs) the kernel
# splits each tile's segments across the 8 warps of a block
SPLIT_TILES = 4 * 132


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"dia_spmv: {msg}")


class DiaTiles(NamedTuple):
    """K1's layout of diagonals [K, n]: tile t (rows 32t .. 32t+31) owns
    segments seg_ptr[t] .. seg_ptr[t+1]-1, each one diagonal (offset
    seg_off[s], increasing within a tile) with a nonzero value in the
    tile's rows, its 32 values in seg_vals[s] (zero past row n). `split`
    picks the kernel's split form, from n alone. `offsets` are the
    operator's K dense offsets and `state` the kernel's flag and ticket
    for non-finite x (see the module doc); `repair` says whether the
    layout skips a segment that a row reaches in range, the only case in
    which the kernel needs them."""
    seg_ptr: torch.Tensor   # [n_tiles + 1] int32
    seg_off: torch.Tensor   # [n_segs] int32
    seg_vals: torch.Tensor  # [n_segs, TILE] f32 or bf16
    n: int
    split: bool
    offsets: torch.Tensor   # [K] int32
    state: torch.Tensor     # [2] int32, zero between launches
    repair: bool

    @property
    def n_segs(self) -> int:
        return self.seg_off.shape[0]

    @property
    def nbytes(self) -> int:
        """Bytes the kernel streams for the layout (x and y aside)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.seg_ptr, self.seg_off, self.seg_vals))


def dia_tiles(diags: torch.Tensor,
              offsets: Union[Sequence[int], torch.Tensor]) -> DiaTiles:
    """The compact layout of diagonals [K, n] with sorted offsets [K], on
    their device, with torch ops (no host loop). Exact: scattering the
    segments back gives `diags`."""
    k, n = diags.shape
    dev = diags.device
    n_tiles = -(-n // TILE)
    full = n // TILE
    with torch.no_grad():
        nz = diags.ne(0)
        mask = torch.zeros(n_tiles, k, dtype=torch.bool, device=dev)
        if full:
            mask[:full] = nz[:, :full * TILE].view(k, full, TILE).any(-1).T
        if full < n_tiles:
            mask[full] = nz[:, full * TILE:].any(-1)
        del nz
        tile, kk = mask.nonzero(as_tuple=True)  # by tile, then k
        _require(tile.shape[0] < 2 ** 31, "more segments than int32 holds")
        seg_ptr = torch.zeros(n_tiles + 1, dtype=torch.int64, device=dev)
        torch.cumsum(mask.sum(1), 0, out=seg_ptr[1:])
        offs = torch.as_tensor(offsets, device=dev).to(torch.int32)
        seg_off = offs[kk]
        # a skipped (tile, k) that one of the tile's rows reaches in range
        lo = torch.arange(n_tiles, device=dev)[:, None] * TILE
        hi = (lo + TILE - 1).clamp_(max=n - 1)
        off = offs.long()[None, :]
        repair = bool((~mask & (hi + off >= 0) & (lo + off < n)).any())
        rows = tile[:, None] * TILE + torch.arange(TILE, device=dev)
        inside = rows < n
        flat = kk[:, None] * n + rows.clamp_(max=max(n - 1, 0))
        seg_vals = diags.reshape(-1)[flat].masked_fill_(~inside, 0)
    return DiaTiles(seg_ptr.to(torch.int32), seg_off.contiguous(), seg_vals,
                    n, n_tiles < SPLIT_TILES, offs.contiguous(),
                    torch.zeros(2, dtype=torch.int32, device=dev), repair)


def _on(tiles: DiaTiles, device: torch.device) -> DiaTiles:
    """The layout with its tensors on `device` (itself where they are)."""
    return tiles._replace(**{f: getattr(tiles, f).to(device) for f in (
        "seg_ptr", "seg_off", "seg_vals", "offsets", "state")})


def _check_operands(tiles: DiaTiles, x: torch.Tensor) -> None:
    """Raise ValueError unless K1 takes the layout `tiles` and x."""
    _require(x.device.type == "cuda", f"x lies on {x.device}, not CUDA")
    ptr, off, vals = tiles.seg_ptr, tiles.seg_off, tiles.seg_vals
    offs, state = tiles.offsets, tiles.state
    _require(all(t.device == x.device for t in (ptr, off, vals, offs, state)),
             "the layout and x must share one device")
    _require(vals.dtype in DIAG_DTYPES and x.dtype == torch.float32,
             "diagonal values must be float32 or bfloat16 and x float32")
    _require(all(t.dtype == torch.int32 for t in (ptr, off, offs, state)),
             "segment pointers and offsets must be int32")
    _require(offs.ndim == 1 and offs.shape[0] >= 1 and state.shape == (2,),
             f"offsets {tuple(offs.shape)} and state {tuple(state.shape)}: "
             "[K >= 1] and [2] expected")
    n = tiles.n
    _require(x.ndim == 1 and x.shape[0] == n
             and ptr.shape == (-(-n // TILE) + 1,)
             and vals.shape == (off.shape[0], TILE),
             f"shapes seg_ptr {tuple(ptr.shape)}, seg_off "
             f"{tuple(off.shape)}, seg_vals {tuple(vals.shape)}, x "
             f"{tuple(x.shape)} disagree with n={n}")
    _require(n < 2 ** 31 - TILE, f"n={n} exceeds the kernel's int32 rows")
    _require(all(t.is_contiguous() for t in (ptr, off, vals, offs, x)),
             "inputs must be contiguous")


def dia_tiles_spmv_cuda(tiles: DiaTiles, x: torch.Tensor,
                        b: Optional[torch.Tensor] = None,
                        d: Optional[torch.Tensor] = None,
                        omega: float = 0.0) -> torch.Tensor:
    """Launch K1 into a new vector for A's compact layout `tiles` (from
    `dia_tiles`) and x [n] f32: y = A x; with b, the residual form b - A x;
    with b and d, the Jacobi form x + rn(rn(1 / d) * omega) * (b - A x),
    each step rounded as the eager chain does. All contiguous on one CUDA
    device, b and d [n] f32 vectors."""
    _check_operands(tiles, x)
    if b is not None or d is not None:
        _require(all(v is not None and v.device == x.device
                     and v.dtype == torch.float32 and v.shape == x.shape
                     and v.is_contiguous()
                     for v in ((b,) if d is None else (b, d))),
                 "b and d must be contiguous float32 vectors shaped as x, "
                 "on x's device")
    ptr, off, vals = tiles.seg_ptr, tiles.seg_off, tiles.seg_vals
    offs, state, n = tiles.offsets, tiles.state, tiles.n
    out = torch.empty_like(x)
    lib = _build.load()
    fn, name = ((lib.dia_spmv_f32, "dia_spmv_f32")
                if vals.dtype == torch.float32
                else (lib.dia_spmv_bf16, "dia_spmv_bf16"))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check(fn(ptr.data_ptr(), off.data_ptr(), vals.data_ptr(), n,
                        int(tiles.split), offs.data_ptr(), offs.shape[0],
                        state.data_ptr() if tiles.repair else None,
                        x.data_ptr(), None if b is None else b.data_ptr(),
                        None if d is None else d.data_ptr(), omega,
                        out.data_ptr(), stream), name)
    return out


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
    x's cotangent K1 on the transposed layout, the diagonals'
    `diags_cotangent`; each only when autograd asks for it. `diags` is
    the operator's own tensor, passed so that autograd tracks it; the
    launch reads the layout built from it."""

    @staticmethod
    def forward(ctx, x, diags, op):
        ctx.op = op
        if ctx.needs_input_grad[1]:
            ctx.save_for_backward(x)
        return op.launch(x)

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
    layout); it never moves on the CPU path, which runs the plain
    version. `fused_launches` counts those of them that ran a vertex
    update (`jacobi_sweep`, `residual`), each in place of a plain launch.
    `rebuilds` counts the compactions after construction (the
    diagonals replaced or updated in place). `diag_dtype` (float32 or
    bfloat16; default: the dtype of `diags`) is the storage of the
    diagonal stream; `diagonal()` stays the f32 diagonal given, as the JAX
    operator's `diag` leaf does. `device` (default: the diagonals') is
    where the layouts live and `diagonal()` lies; the diagonals stay where
    they are given (see the module doc)."""

    def __init__(self, diags: torch.Tensor, offsets: Tuple[int, ...],
                 n: int, nnz: int, diag_dtype=None, device=None):
        diag_dtype = diag_dtype or diags.dtype
        if diag_dtype not in DIAG_DTYPES:
            raise ValueError(f"dia_spmv: diag_dtype {diag_dtype} is not one "
                             "of float32, bfloat16")
        self.device = (diags.device if device is None
                       else torch.empty(0, device=device).device)
        self.offsets = tuple(int(o) for o in offsets)
        k0 = self.offsets.index(0)
        # a copy: a view would keep the whole f32 source array alive
        self._diag = (None if diags.dtype == diag_dtype == torch.float32
                      and diags.device == self.device
                      else diags[k0].detach().to(self.device, torch.float32,
                                                 copy=True))
        self.diags = diags.to(diag_dtype).contiguous()
        self.n = int(n)
        self.nnz = int(nnz)
        self.launches = 0
        self.fused_launches = 0
        self.rebuilds = 0
        self._key = None
        self.layout()

    @property
    def n_rows(self) -> int:
        return self.n

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    def plain(self) -> DIAOperator:
        """The same operator on the plain PyTorch path (shares tensors)."""
        return DIAOperator(self.diags, self.offsets, self.n, self.nnz)

    def layouts(self) -> Tuple[DiaTiles, DiaTiles]:
        """The compact layouts of A and A^T (see `layout`, `tiles_t`)."""
        return self.layout(), self.tiles_t

    def layout(self) -> DiaTiles:
        """A's compact layout, built from the stored diagonals at
        construction and again only if they were replaced or updated in
        place since; a rebuild drops A^T's layout, which the next
        `tiles_t` builds anew."""
        key = self._layout_key()
        if self._key != key:
            if self._key is not None:
                self.rebuilds += 1
            with torch.no_grad():
                self.tiles = _on(dia_tiles(self.diags, self.offsets),
                                 self.device)
            self._tiles_t = self.transposed = None
            self._key = key
        guard(self._layout_key, key)  # a captured program replays on these
        return self.tiles

    @property
    def tiles_t(self) -> DiaTiles:
        """A^T's compact layout (x's cotangent), built on first use, so
        an operator that is only applied forward never builds it. A^T's
        dense diagonals, which the plain version needs, are kept only on
        the CPU: on the card they would double the operator's memory for
        nothing the kernel reads."""
        self.layout()
        if self._tiles_t is None:
            with torch.no_grad():
                t = dia_transpose(self.plain())
                self._tiles_t = _on(dia_tiles(t.diags, t.offsets),
                                    self.device)
            self.transposed = t if self.device.type == "cpu" else None
        return self._tiles_t

    def _layout_key(self):
        return (self.diags.data_ptr(), self.diags._version)

    def launch(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x with no autograd: K1 on a CUDA tensor (counted), the
        plain version on a CPU tensor."""
        return self._apply(x)

    def launch_t(self, ybar: torch.Tensor) -> torch.Tensor:
        """A^T ybar: K1 on the transposed layout (counted) on a CUDA
        tensor, the plain version on a CPU tensor."""
        tiles_t = self.tiles_t
        if ybar.device.type == "cpu":
            t = self.transposed
            return dia_matvec(t.diags, t.offsets, ybar)
        y = dia_tiles_spmv_cuda(tiles_t, ybar)
        count(self, "launches")
        return y

    def fuses(self, *vectors: torch.Tensor) -> bool:
        """Whether `jacobi_sweep` and `residual` take these vectors: all
        float32 [n] vectors, and autograd needs nothing of them or of the
        diagonals (the fused forms have no backward)."""
        return (all(v.dtype == torch.float32 and v.ndim == 1
                    for v in vectors)
                and not (torch.is_grad_enabled() and (
                    self.diags.requires_grad
                    or any(v.requires_grad for v in vectors))))

    def jacobi_sweep(self, b: torch.Tensor, x: torch.Tensor, omega: float,
                     d: torch.Tensor) -> torch.Tensor:
        """One Jacobi sweep x + (omega / d) * (b - A x), d the smoother's
        diagonal: K1's Jacobi form, one launch, on CUDA tensors; the same
        eager chain on CPU tensors. No autograd (see `fuses`)."""
        return self._apply(x, b, d, omega)

    def residual(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """b - A x: K1's residual form, one launch, on CUDA tensors; the
        eager difference on CPU tensors. No autograd (see `fuses`)."""
        return self._apply(x, b)

    def _apply(self, x, b=None, d=None, omega=0.0) -> torch.Tensor:
        """A x, b - A x or x + (omega / d) * (b - A x) (as b and d are
        given): one K1 launch on a CUDA tensor, counted, its host enqueue a
        span while a profiler records; the plain version and the eager
        chain on a CPU tensor."""
        if x.device.type == "cpu":
            y = dia_matvec(self.diags, self.offsets, x)
            if b is None:
                return y
            return b - y if d is None else x + (omega / d) * (b - y)
        update = () if b is None else (b, d, omega)
        state = (span_begin("k1.launch", host_only=True)
                 if _profiler._is_profiler_enabled else None)
        try:
            out = dia_tiles_spmv_cuda(self.layout(), x, *update)
            count(self, "launches")
            if update:
                count(self, "fused_launches")
        finally:
            span_end(state)
        return out

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim > 1:
            raise ValueError("DiaKernelOperator matvec is vector-only")
        if torch.is_grad_enabled() and (x.requires_grad
                                        or self.diags.requires_grad):
            return _DiaGrad.apply(x, self.diags, self)
        return self.launch(x)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x)

    def diagonal(self) -> torch.Tensor:
        if self._diag is not None:
            return self._diag
        return self.diags[self.offsets.index(0)]


def dia_kernel_operator(dia: DIAOperator, diag_dtype=None,
                        device=None) -> DiaKernelOperator:
    """Wrap a DIAOperator in kernel K1 (solver protocol), with the
    diagonals stored in `diag_dtype` (float32 or bfloat16) and the layouts
    on `device` (default: the diagonals'). The port's counterpart of both
    `pallas_dia_operator` and `make_dia_spmv_padded(dia, diag_dtype=...)`:
    with no padded layout the two are one."""
    return DiaKernelOperator(dia.diags, dia.offsets, dia.n, dia.nnz,
                             diag_dtype, device)


def dia_twin(op, max_offsets: int = 512, kernel: bool = False):
    """`op` as its DIA twin where it is a COO `SparseOperator` banded
    enough (`to_dia` refuses more than `max_offsets` diagonals; such an
    operator stays COO), and with `kernel` a DIA operator on K1; any other
    operator as it is."""
    if isinstance(op, SparseOperator):
        try:
            op = to_dia(op, max_offsets)
        except ValueError:
            return op  # too irregular — keep the COO path
    if kernel and isinstance(op, DIAOperator):
        op = dia_kernel_operator(op)
    return op
