"""Kernel K4, the fused grid stencil — the counterpart of the kernel half
of gnnla_tpu/ops/pallas_stencil.py.

  * `stencil_form` — which of the kernel's two forms a call takes, with
    its tile and halo (`tile_form`): the tile form runs every step of a
    call in one launch out of shared memory; the per-step form launches
    once per step (see `csrc/stencil.cu`).
  * `stencil_cuda` — the raw launcher of `csrc/stencil.cu` (CUDA tensors
    only; it raises on anything else).
  * `StencilCall` — the counterpart of the call `_build_stencil_call`
    returns: fixed taps, shifts, grid, n_steps and mode, and the form
    chosen for them once; calling it launches K4 on CUDA tensors and runs
    the plain version (`ops/stencil.py::stencil_apply_plain`) only for CPU
    tensors. `launches` counts kernel launches (`stencil_launches`).
  * `StencilSpMV`, `StencilJacobi`, `StencilPower`, `StencilResidual` and
    the `make_stencil_*` constructors — the four users of the kernel
    (`PallasStencil*` in the JAX package), with the same taps.

`StencilSpMV` is differentiable in x and in its taps with the VJP of
`PallasStencilSpMV` (`pallas_stencil.py:336-356`): x's cotangent is K4 in
plain mode on the transposed taps (`stencil_transpose`, rebuilt from the
saved taps in backward), the taps' cotangent autograd through the plain
roll twin `stencil_matvec` repeated n_steps times (JAX's `f_jnp`). The
JAX package defines no gradient for the other users (Jacobi, power,
residual), so with grad mode on their K4 calls refuse inputs that require
grad, on the CPU as on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gnnla_tpu_torch import _build
from gnnla_tpu_torch.ops.stencil import (MAX_TAPS, MODES, check_mode,
                                         stencil_apply_plain, stencil_matvec,
                                         stencil_taps, stencil_transpose)
from gnnla_tpu_torch.utils.program import count

_THREADS = 256  # the step kernel's block size (kThreads in csrc/stencil.cu)
_MODE_ID = {"plain": 0, "affine": 1, "normalize": 2}
_FORM_ID = {"step": 0, "tile": 1}
# the tile form's output tiles (rows, columns), cut to the grid, in the
# order `stencil_form` tries them
TILES = ((16, 128), (32, 128))


class StencilForm(NamedTuple):
    """How K4 runs a call. form "tile": one launch; each block owns a
    `tile` (rows, columns) of the output, stages x over it and a `halo`
    (rows up, rows down, columns left, columns right) in shared memory and
    runs every step there; `vec` columns a thread. form "step": one launch
    per step (tile, halo None)."""
    form: str
    tile: Optional[Tuple[int, int]]
    halo: Optional[Tuple[int, int, int, int]]
    vec: int

    @property
    def region(self) -> Optional[Tuple[int, int]]:
        """The staged region (rows, columns) of one block."""
        if self.tile is None:
            return None
        up, down, left, right = self.halo
        return self.tile[0] + up + down, self.tile[1] + left + right


def stencil_vec(grid_shape: Tuple[int, int], tap_dtype) -> int:
    """Columns a thread of the tile form computes: one 16-byte tap load
    per shift (4 f32, 8 bf16) where the grid's width allows it, else 1.
    (The kernel also takes 1 for operands that are not 16-byte aligned,
    which the port's own tensors always are.)"""
    v = 16 // torch.empty((), dtype=tap_dtype).element_size()
    return v if grid_shape[1] % v == 0 else 1


def stencil_reach(shifts: Sequence[Tuple[int, int]],
                  grid_shape: Tuple[int, int]) -> Tuple[int, int, int, int]:
    """How far one step reads from a point: (rows up, rows down, columns
    left, columns right). A shift dy in [0, H) reaches dy or dy - H,
    whichever is smaller in magnitude (dy itself on a tie); likewise dx."""
    h, w = grid_shape
    sy = [dy % h if 2 * (dy % h) <= h else dy % h - h for dy, _ in shifts]
    sx = [dx % w if 2 * (dx % w) <= w else dx % w - w for _, dx in shifts]
    return (max(0, -min(sy)), max(0, max(sy)), max(0, -min(sx)),
            max(0, max(sx)))


def tile_form(shifts: Sequence[Tuple[int, int]],
              grid_shape: Tuple[int, int], n_steps: int, tap_dtype,
              tile: Tuple[int, int]) -> StencilForm:
    """The tile form of a call on `tile` (rows, columns), cut to the grid:
    the halo is n_steps reaches on each side, columns rounded up to the
    vector width."""
    h, w = grid_shape
    vec = stencil_vec(grid_shape, tap_dtype)
    up, down, left, right = stencil_reach(shifts, grid_shape)
    halo = (n_steps * up, n_steps * down,
            n_steps * (-(-left // vec) * vec),
            n_steps * (-(-right // vec) * vec))
    return StencilForm("tile", (min(tile[0], h),
                                min(tile[1], -(-w // vec) * vec)), halo, vec)


def stencil_form(shifts: Sequence[Tuple[int, int]],
                 grid_shape: Tuple[int, int], n_steps: int, mode: str,
                 tap_dtype) -> StencilForm:
    """The form K4 takes for a call (a pure function of its arguments).

    The tile form, for plain and affine mode at n_steps >= 2, on the first
    tile of TILES whose staged region (`tile_form`) holds at most twice
    the tile's points: past that the halo's redundant work and reads
    outweigh the saved steps (and the two buffers stay within 128 KB of
    shared memory). Everything else runs per step: normalize mode, whose
    norm spans the whole grid in every step; operators whose halo no tile
    takes; and one-step calls, which have no step to save and where
    staging x before the tap loads measured slower on the H100 (one launch
    either way)."""
    if mode != "normalize" and n_steps > 1:
        for tile in TILES:
            form = tile_form(shifts, grid_shape, n_steps, tap_dtype, tile)
            rows, cols = form.region
            if rows * cols <= 2 * form.tile[0] * form.tile[1]:
                return form
    return StencilForm("step", None, None,
                       stencil_vec(grid_shape, tap_dtype))


def stencil_launches(mode: str, n_steps: int, form: str = "step") -> int:
    """Kernel launches of one call: 1 in the tile form; per step, n_steps
    (plain, affine) or 2 n_steps + 1 (normalize, whose norm takes a
    finalize launch per step and a last scaling pass)."""
    if form == "tile":
        return 1
    return 2 * n_steps + 1 if mode == "normalize" else n_steps


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"stencil: {msg}")


def shifts_tensor(shifts: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """The host int32 [2K] shifts (dy's, then dx's) the kernel takes."""
    return torch.tensor([dy for dy, _ in shifts] + [dx for _, dx in shifts],
                        dtype=torch.int32)


def stencil_cuda(taps: torch.Tensor, shifts: torch.Tensor,
                 x2d: torch.Tensor, n_steps: int, mode: str,
                 c: Optional[torch.Tensor] = None,
                 form: Optional[StencilForm] = None) -> torch.Tensor:
    """Launch K4: n_steps of the stencil in `mode` on x2d [H, W] f32 with
    taps [K, H, W] (f32 or bf16) and c, all contiguous on one CUDA device,
    and shifts [2K] int32 (the dy's, then the dx's) on the CPU (or on the
    device, at the cost of a copy to the host). Returns a new [H, W]. The
    kernel takes each shift modulo H and W, as the plain version's roll
    does, so no shift can make it read outside x. `form` defaults to
    `stencil_form`'s choice for these shifts."""
    check_mode(mode, c)
    _require(x2d.device.type == "cuda", f"x lies on {x2d.device}, not CUDA")
    ins = (taps,) + (() if c is None else (c,))
    _require(all(t.device == x2d.device for t in ins),
             "taps, c and x must share one device")
    _require(taps.dtype in (torch.float32, torch.bfloat16),
             "taps must be float32 or bfloat16")
    _require(x2d.dtype == torch.float32
             and (c is None or c.dtype == torch.float32),
             "x and c must be float32")
    _require(shifts.dtype == torch.int32, "shifts must be int32")
    _require(taps.ndim == 3 and x2d.ndim == 2, "taps [K, H, W] and x [H, W] "
             "expected")
    k, h, w = taps.shape
    _require(1 <= k <= MAX_TAPS, f"K={k} taps; 1 to {MAX_TAPS} supported")
    _require(x2d.shape == (h, w) and shifts.shape == (2 * k,)
             and (c is None or c.shape == (h, w)),
             f"shapes taps {tuple(taps.shape)}, shifts "
             f"{tuple(shifts.shape)}, x {tuple(x2d.shape)}"
             + ("" if c is None else f", c {tuple(c.shape)}") + " disagree")
    _require(h * w < 2 ** 31, "grid must have fewer than 2^31 points")
    _require(n_steps >= 1, "n_steps must be >= 1")
    _require(all(t.is_contiguous() for t in ins + (x2d, shifts)),
             "inputs must be contiguous")
    shifts = shifts.cpu()
    if form is None:
        sh = shifts.tolist()
        form = stencil_form(list(zip(sh[:k], sh[k:])), (h, w), n_steps,
                            mode, taps.dtype)
    _require(form.form == "step" or mode != "normalize",
             "normalize mode runs in the per-step form")
    bufs = stencil_buffers(x2d, n_steps, mode, form)
    args = stencil_args(taps, shifts, x2d, n_steps, mode, c, *bufs, form)
    lib = _build.load()
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        _build.check(lib.stencil_f32(*args, stream), "stencil_f32")
    return bufs[0]


def stencil_buffers(x2d: torch.Tensor, n_steps: int, mode: str,
                    form: StencilForm):
    """(out, tmp, scratch) for one call: the output, the per-step form's
    ping-pong buffer (n_steps > 1) and its normalize mode's per-block
    partials + scale."""
    h, w = x2d.shape
    out = torch.empty_like(x2d)
    per_step = form.form == "step"
    tmp = torch.empty_like(x2d) if per_step and n_steps > 1 else None
    scratch = None
    if mode == "normalize":
        scratch = x2d.new_empty(-(-h * w // _THREADS) + 1)
    return out, tmp, scratch


def stencil_args(taps, shifts, x2d, n_steps, mode, c, out, tmp, scratch,
                 form: StencilForm) -> tuple:
    """The arguments of the C entry point `stencil_f32`, all but the
    stream, for checked operands, host int32 shifts and buffers from
    `stencil_buffers`."""
    k, h, w = taps.shape

    def ptr(t):
        return None if t is None else t.data_ptr()

    th, tw = form.tile or (0, 0)
    return (taps.data_ptr(), int(taps.dtype == torch.bfloat16),
            shifts.data_ptr(), k, h, w, x2d.data_ptr(), ptr(c),
            out.data_ptr(), ptr(tmp), ptr(scratch),
            0 if scratch is None else scratch.numel(), n_steps,
            _MODE_ID[mode], _FORM_ID[form.form], th, tw)


class StencilCall:
    """n_steps of K4 in one mode with fixed taps [K, H, W] and shifts (the
    counterpart of the call object `_build_stencil_call` builds, which
    binds the grid too).

    call(x2d, c=None) -> y2d: on CUDA tensors K4, on CPU tensors the plain
    version. x2d (and c) must lie on the taps' H x W grid. `form` is the
    `StencilForm` the kernel takes, chosen here once. `launches` counts
    kernel launches; it never moves on the CPU path.

    Not differentiable: with grad mode on, an input that requires grad
    raises NotImplementedError on either path. `StencilSpMV` carries the
    one gradient the JAX package defines."""

    def __init__(self, shifts: Sequence[Tuple[int, int]],
                 taps: torch.Tensor, n_steps: int, mode: str):
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        if mode not in MODES:
            raise ValueError(f"stencil mode must be one of {MODES}, "
                             f"got {mode!r}")
        self.shifts = [(int(dy), int(dx)) for dy, dx in shifts]
        _require(taps.ndim == 3 and taps.shape[0] == len(self.shifts),
                 f"taps {tuple(taps.shape)} for {len(self.shifts)} shifts; "
                 "[K, H, W] expected")
        _, h, w = taps.shape
        bad = [s for s in self.shifts
               if not (0 <= s[0] < h and 0 <= s[1] < w)]
        _require(not bad, f"shifts {bad[:4]} lie outside the {h}x{w} grid "
                 "(0 <= dy < H, 0 <= dx < W)")
        self.taps = taps
        self.grid_shape = (int(h), int(w))
        self.n_steps = int(n_steps)
        self.mode = mode
        self.shifts_host = shifts_tensor(self.shifts)
        self.form = stencil_form(self.shifts, self.grid_shape, self.n_steps,
                                 mode, taps.dtype)
        self.launches = 0

    def plain(self, x2d: torch.Tensor,
              c: Optional[torch.Tensor] = None) -> torch.Tensor:
        return stencil_apply_plain(self.taps, self.shifts, x2d, self.n_steps,
                                   self.mode, c)

    def __call__(self, x2d: torch.Tensor,
                 c: Optional[torch.Tensor] = None) -> torch.Tensor:
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (self.taps, x2d, c)):
            raise NotImplementedError(
                f"the stencil kernel in {self.mode} mode has no gradient: "
                "the JAX package defines no VJP for its Jacobi, power and "
                "residual users (only PallasStencilSpMV has one; see "
                "StencilSpMV)")
        _require(tuple(x2d.shape) == self.grid_shape,
                 f"x {tuple(x2d.shape)} is not on the call's "
                 f"{self.grid_shape[0]}x{self.grid_shape[1]} grid")
        if x2d.device.type == "cpu":
            return self.plain(x2d, c)
        y = stencil_cuda(self.taps, self.shifts_host, x2d, self.n_steps,
                         self.mode, c, self.form)
        count(self, "launches", stencil_launches(self.mode, self.n_steps,
                                                 self.form.form))
        return y


def taps_tensor(planes: np.ndarray, grid_shape, tap_dtype,
                device) -> torch.Tensor:
    """Host float64 planes [K, H*W] as [K, H, W] taps of tap_dtype on
    device, rounded once from float64 as the JAX package does."""
    h, w = grid_shape
    return torch.from_numpy(planes).to(tap_dtype).reshape(-1, h, w).to(device)


class _StencilSpMVGrad(torch.autograd.Function):
    """y = T^n x on K4 with the VJP of `PallasStencilSpMV.apply`: x's
    cotangent (T^T)^n ybar on K4 with the transposed taps, rebuilt from
    the saved taps; the taps' cotangent through the plain roll twin."""

    @staticmethod
    def forward(ctx, taps, x2d, spmv):
        ctx.spmv = spmv
        ctx.save_for_backward(taps, x2d)
        return spmv._call(x2d)

    @staticmethod
    def backward(ctx, ybar):
        spmv = ctx.spmv
        taps, x2d = ctx.saved_tensors
        ybar = ybar.contiguous()
        tbar = xbar = None
        if ctx.needs_input_grad[1]:
            _, planes_t = stencil_transpose(spmv.shifts, taps.float())
            xbar = spmv.launch_t(planes_t.to(taps.dtype), ybar)
        if ctx.needs_input_grad[0]:
            with torch.enable_grad():
                t = taps.detach().requires_grad_(True)
                tf, y = t.float(), x2d.detach()
                for _ in range(spmv.n_steps):
                    y = stencil_matvec(tf, spmv.shifts, y)
                tbar, = torch.autograd.grad(y, t, ybar)
        return tbar, xbar, None


class StencilSpMV:
    """Fused y = A^{n_steps} x for grid-stencil operators
    (`PallasStencilSpMV`).

    apply(x2d) -> y2d    [H, W] f32 in and out
    matvec_n(x)          on flat [n] vectors

    Differentiable in x and in `taps` (the JAX package's custom VJP).
    `launches_t` counts the K4 launches of x's cotangent (on the
    transposed taps, in the form `form_t`: one per backward in the tile
    form); the forward's are `_call.launches`. Neither moves on the CPU
    path."""

    def __init__(self, op, grid_shape: Tuple[int, int], n_steps: int = 1,
                 tap_dtype=None):
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1")
        tap_dtype = tap_dtype or op.vals.dtype
        shifts, planes = stencil_taps(op, grid_shape)
        self.grid_shape = (int(grid_shape[0]), int(grid_shape[1]))
        self.shifts = shifts
        self.n = op.shape[0]
        self.nnz = op.nnz
        self.n_steps = n_steps
        self.taps = taps_tensor(planes, grid_shape, tap_dtype, op.device)
        self._call = StencilCall(shifts, self.taps, n_steps, "plain")
        h, w = self.grid_shape
        self.shifts_t = [((-dy) % h, (-dx) % w) for dy, dx in shifts]
        self._shifts_t_host = shifts_tensor(self.shifts_t)
        self.form_t = stencil_form(self.shifts_t, self.grid_shape, n_steps,
                                   "plain", self.taps.dtype)
        self.launches_t = 0

    def apply(self, x2d: torch.Tensor) -> torch.Tensor:
        x2d = x2d.float()
        if torch.is_grad_enabled() and (x2d.requires_grad
                                        or self.taps.requires_grad):
            return _StencilSpMVGrad.apply(self.taps, x2d, self)
        return self._call(x2d)

    def launch_t(self, taps_t: torch.Tensor,
                 y2d: torch.Tensor) -> torch.Tensor:
        """(A^T)^{n_steps} y for A^T's taps: K4 in plain mode on a CUDA
        tensor (counted in `launches_t`), the plain version on a CPU one."""
        if y2d.device.type == "cpu":
            return stencil_apply_plain(taps_t, self.shifts_t, y2d,
                                       self.n_steps, "plain")
        out = stencil_cuda(taps_t, self._shifts_t_host, y2d, self.n_steps,
                           "plain", None, self.form_t)
        count(self, "launches_t", stencil_launches("plain", self.n_steps,
                                                   self.form_t.form))
        return out

    def matvec_n(self, x: torch.Tensor) -> torch.Tensor:
        """y = A^{n_steps} x on flat [n] vectors."""
        return self.apply(x.reshape(self.grid_shape)).reshape(-1)


class StencilJacobi:
    """Fused weighted-Jacobi sweeps (`PallasStencilJacobi`).

    n_iters of x <- x + omega D^-1 (b - A x), as the affine iteration
    x <- M x + c with M = I - omega D^-1 A (A's shift classes plus the
    identity) and c = omega b / d. M is built in float64 on the host,
    exactly as in the JAX package, and cast once at the end.

    run(b2d, x2d) -> x2d' on [H, W] grids, smooth(b, x) on flat [n]
    vectors."""

    def __init__(self, op, grid_shape: Tuple[int, int], omega: float,
                 n_iters: int, diag=None, tap_dtype=None):
        h, w = grid_shape
        tap_dtype = tap_dtype or op.vals.dtype
        shifts, planes = stencil_taps(op, grid_shape)
        src = op.diagonal() if diag is None else torch.as_tensor(diag)
        d = src.detach().cpu().numpy().astype(np.float64).reshape(-1)
        planes = -omega * planes / d[None, :]
        if (0, 0) not in shifts:
            shifts = [(0, 0)] + shifts
            planes = np.concatenate([np.zeros((1, h * w)), planes], axis=0)
        planes[shifts.index((0, 0))] += 1.0

        self.grid_shape = (int(h), int(w))
        self.n = op.shape[0]
        self.nnz = op.nnz
        self.n_iters = n_iters
        self.omega = omega
        self.taps = taps_tensor(planes, grid_shape, tap_dtype, op.device)
        self._d2 = torch.from_numpy(d.reshape(h, w)).float().to(op.device)
        self._call = StencilCall(shifts, self.taps, n_iters, "affine")

    def run(self, b2d: torch.Tensor, x2d: torch.Tensor) -> torch.Tensor:
        c = (self.omega * b2d / self._d2).float()
        return self._call(x2d.float(), c)

    def smooth(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """n_iters Jacobi sweeps on flat [n] vectors."""
        return self.run(b.reshape(self.grid_shape),
                        x.reshape(self.grid_shape)).reshape(-1)


class StencilPower:
    """Fused normalized power iterations (`PallasStencilPower`): n_iters of
    b <- A b / ||A b||_2; the Rayleigh quotient is taken on the returned
    iterate with the operator's own matvec."""

    def __init__(self, op, grid_shape: Tuple[int, int], n_iters: int,
                 tap_dtype=None):
        tap_dtype = tap_dtype or op.vals.dtype
        shifts, planes = stencil_taps(op, grid_shape)
        self._op = op
        self.grid_shape = (int(grid_shape[0]), int(grid_shape[1]))
        self.n = op.shape[0]
        self.nnz = op.nnz
        self.n_iters = n_iters
        self.taps = taps_tensor(planes, grid_shape, tap_dtype, op.device)
        self._call = StencilCall(shifts, self.taps, n_iters, "normalize")

    def apply(self, b2d: torch.Tensor) -> torch.Tensor:
        return self._call(b2d.float())

    def run(self, b0: torch.Tensor):
        """(lambda_max, b) after n_iters normalized iterations."""
        b = self.apply(b0.reshape(self.grid_shape)).reshape(-1)
        lam = torch.dot(b, self._op.matvec(b)) / torch.dot(b, b)
        return lam, b


class StencilResidual:
    """Fused r = b - A x in one pass (`PallasStencilResidual`): the affine
    mode with taps = -A and c = b."""

    def __init__(self, op, grid_shape: Tuple[int, int], tap_dtype=None):
        tap_dtype = tap_dtype or op.vals.dtype
        shifts, planes = stencil_taps(op, grid_shape)
        self.grid_shape = (int(grid_shape[0]), int(grid_shape[1]))
        self.n = op.shape[0]
        self.nnz = op.nnz
        self.taps = taps_tensor(-planes, grid_shape, tap_dtype, op.device)
        self._call = StencilCall(shifts, self.taps, 1, "affine")

    def run(self, b2d: torch.Tensor, x2d: torch.Tensor) -> torch.Tensor:
        return self._call(x2d.float(), b2d.float())

    def residual(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """r = b - A x on flat [n] vectors."""
        return self.run(b.reshape(self.grid_shape),
                        x.reshape(self.grid_shape)).reshape(-1)


def make_stencil_spmv(op, grid_shape: Tuple[int, int], n_steps: int = 1,
                      tap_dtype=None) -> StencilSpMV:
    """The fused stencil SpMV (see StencilSpMV)."""
    return StencilSpMV(op, grid_shape, n_steps, tap_dtype)


def make_stencil_jacobi(op, grid_shape: Tuple[int, int], omega: float = 0.7,
                        n_iters: int = 3, diag=None,
                        tap_dtype=None) -> StencilJacobi:
    """Fused weighted-Jacobi smoother; `diag` overrides the operator
    diagonal (trained-Jacobi integration)."""
    return StencilJacobi(op, grid_shape, omega, n_iters, diag, tap_dtype)


def make_stencil_power(op, grid_shape: Tuple[int, int], n_iters: int = 10,
                       tap_dtype=None) -> StencilPower:
    """Fused normalized power iteration."""
    return StencilPower(op, grid_shape, n_iters, tap_dtype)


def make_stencil_residual(op, grid_shape: Tuple[int, int],
                          tap_dtype=None) -> StencilResidual:
    """Fused r = b - A x stencil call."""
    return StencilResidual(op, grid_shape, tap_dtype)
