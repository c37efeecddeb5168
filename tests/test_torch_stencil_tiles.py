"""Kernel K4's tile form (`ops/stencil_kernel.py::stencil_form` and the
walk of `csrc/stencil.cu::stencil_tile`) on the CPU.

`stencil_form` is checked on the four operators of test_torch_stencil.py
(the 5-point Laplacian, a non-symmetric operator on its pattern, the
periodic 9-class diffusion FEM, whose wraps reach across the grid, and the
stretched 9-point FEM): the form, the tile and each side's halo.

`tile_walk` below emulates the kernel's tile form in plain PyTorch: per
tile, x over the tile and its halo gathered modulo H and W, every step
over a region that shrinks by one reach per step, only the tile written.
It must give `stencil_apply_plain`'s bits: the kernel rounds each product
and sum as the plain version does, in the same order (tap_0 * v_0, then
the taps in shift order, then c), and a halo point holds the value of the
grid point it wraps to. The same walk, on inputs made with numpy from a
seed, is held to the JAX package's `PallasStencil*` in interpret mode at
test_torch_stencil.py's tolerance (rtol 1e-5, atol 1e-5 * max|y|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnnla_tpu.ops import pallas_stencil as jps
from gnnla_tpu.ops.sparse import SparseOperator as JSparse
from gnnla_tpu.problems import laplacian_2d as j_laplacian_2d
from gnnla_tpu.problems import stretched_mesh_matrix
from gnnla_tpu.problems.diffusion_fem import constant_diffusion_matrix
from gnnla_tpu_torch.ops import stencil_kernel as tk
from gnnla_tpu_torch.ops.sparse import SparseOperator as TSparse
from gnnla_tpu_torch.ops.stencil import stencil_apply_plain, stencil_taps

RTOL = 1e-5
F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    real = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return real(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


def grid_operator(case):
    """(jax op, grid shape) of a test operator."""
    if case == "lap20":
        return j_laplacian_2d(20).eliminate_zeros(), (20, 20)
    if case == "nonsym20":
        A = j_laplacian_2d(20).eliminate_zeros()
        rows, cols, _ = A.host_coo()
        v = np.where(rows == cols, -4.0,
                     np.random.default_rng(0).uniform(0.5, 1.5, rows.size))
        return JSparse.from_coo(rows, cols, v, A.shape), (20, 20)
    if case == "periodic8":
        return constant_diffusion_matrix(1.3, 0.7, 8), (8, 8)
    if case == "fem12":
        return stretched_mesh_matrix(13, stretch=3.0), (12, 12)
    raise KeyError(case)


def carry(op_j):
    rows, cols, vals = op_j.host_coo()
    return TSparse.from_coo(rows, cols, vals, op_j.shape, device="cpu")


def vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def assert_close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def signed(shifts, grid_shape):
    """Each shift as the kernel's tile form reads it: dy or dy - H,
    whichever is smaller in magnitude."""
    h, w = grid_shape
    return [(dy % h if 2 * (dy % h) <= h else dy % h - h,
             dx % w if 2 * (dx % w) <= w else dx % w - w)
            for dy, dx in shifts]


def tile_walk(taps, shifts, x, n_steps, mode, c=None, tile=(16, 128),
              vec_w=1):
    """The kernel's tile form in plain PyTorch (see the module doc). Each
    step's destination starts as NaN, so a read outside the region a step
    computed would show in the result."""
    _, h, w = taps.shape
    up, down, left, right = tk.stencil_reach(shifts, (h, w))
    cl, cr = -(-left // vec_w) * vec_w, -(-right // vec_w) * vec_w
    th, tw = tile
    assert tw % vec_w == 0
    rh0, rw0 = th + n_steps * (up + down), tw + n_steps * (cl + cr)
    sh = signed(shifts, (h, w))
    tf = taps.float()
    out = torch.full((h, w), float("nan"))
    for r0 in range(0, h, th):
        for c0 in range(0, w, tw):
            rr0 = torch.arange(r0 - n_steps * up, r0 - n_steps * up + rh0) % h
            cc0 = torch.arange(c0 - n_steps * cl, c0 - n_steps * cl + rw0) % w
            buf = x[rr0][:, cc0]
            for s in range(1, n_steps + 1):
                m = n_steps - s
                lr, lc = s * up, s * cl
                rows, cols = th + m * (up + down), tw + m * (cl + cr)
                rr, cc = rr0[lr:lr + rows], cc0[lc:lc + cols]
                acc = None
                for k, (dy, dx) in enumerate(sh):
                    xs = buf[lr + dy:lr + dy + rows, lc + dx:lc + dx + cols]
                    term = tf[k][rr][:, cc] * xs
                    acc = term if acc is None else acc + term
                if mode == "affine":
                    acc = acc + c[rr][:, cc]
                nxt = torch.full_like(buf, float("nan"))
                nxt[lr:lr + rows, lc:lc + cols] = acc
                buf = nxt
            kr, kc = min(th, h - r0), min(tw, w - c0)
            out[r0:r0 + kr, c0:c0 + kc] = buf[
                n_steps * up:n_steps * up + kr,
                n_steps * cl:n_steps * cl + kc]
    return out


def random_stencil(shape, dtype, seed, reach=1):
    """Random taps [9 or more, H, W] on the 9-point shifts (periodic
    wraps) and, with reach > 1, two longer ones; x and c [H, W]."""
    h, w = shape
    rng = np.random.default_rng(seed)
    shifts = [(dy % h, dx % w) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    if reach > 1:
        shifts += [(reach % h, (1 - reach) % w), ((-reach) % h, reach % w)]
    taps = torch.from_numpy(rng.uniform(-0.3, 0.3, (len(shifts), h, w))).to(
        dtype)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return shifts, taps, x, c


# --------------------------------------------------------- stencil_form
@pytest.mark.parametrize("case,n_steps,dtype,want", [
    # one step: nothing to save, the per-step form
    ("lap20", 1, F32, ("step", None, None, 4)),
    ("fem12", 1, BF16, ("step", None, None, 1)),
    # 20 x 20, V = 4 f32 columns a thread: the halo outgrows both tiles
    ("lap20", 3, F32, ("step", None, None, 4)),
    # bf16 needs W % 8 == 0 for 16-byte loads: one column a thread here,
    # and the 16-row tile cut to 16 x 20
    ("nonsym20", 2, BF16, ("tile", (16, 20), (2, 2, 2, 2), 1)),
    ("nonsym20", 3, BF16, ("tile", (16, 20), (3, 3, 3, 3), 1)),
    # the periodic FEM's wraps reach one row and column each way
    ("periodic8", 2, BF16, ("step", None, None, 8)),
    ("fem12", 2, BF16, ("tile", (12, 12), (2, 2, 2, 2), 1)),
    ("fem12", 3, BF16, ("step", None, None, 1)),
])
def test_stencil_form_on_the_test_operators(case, n_steps, dtype, want):
    A_j, gs = grid_operator(case)
    shifts, _ = stencil_taps(carry(A_j), gs)
    assert tk.stencil_reach(shifts, gs) == (1, 1, 1, 1)
    form = tk.stencil_form(shifts, gs, n_steps, "plain", dtype)
    assert tuple(form) == want
    assert tk.stencil_form(shifts, gs, n_steps, "affine", dtype) == form


@pytest.mark.parametrize("case", ["lap20", "nonsym20", "periodic8", "fem12"])
def test_stencil_form_at_the_main_path_size(case):
    """The operators' shift sets on the 1024^2 grid (and its 1024 x 512
    coarse grid): at 2 and 3 steps the 16 x 128 tile with n_steps reaches
    a side (columns rounded up to V), f32 and bf16, as the geometric
    cycle's 3-step Jacobi takes it; one step per step, as its Ac apply and
    residual."""
    A_j, gs = grid_operator(case)
    shifts, _ = stencil_taps(carry(A_j), gs)
    h, w = gs
    for big in ((1024, 1024), (1024, 512)):
        # the same classes on the big grid: each signed shift kept
        sh = [(dy % big[0], dx % big[1]) for dy, dx in signed(shifts, gs)]
        for dtype, v in ((F32, 4), (BF16, 8)):
            for n_steps in (2, 3):
                form = tk.stencil_form(sh, big, n_steps, "affine", dtype)
                assert form == ("tile", (16, 128),
                                (n_steps, n_steps, n_steps * v,
                                 n_steps * v), v)
                rows, cols = form.region
                assert rows * cols <= 2 * 16 * 128
                assert tk.stencil_launches("affine", n_steps,
                                           form.form) == 1
            form = tk.stencil_form(sh, big, 1, "plain", dtype)
            assert form == ("step", None, None, v)
            assert tk.stencil_launches("plain", 1, form.form) == 1
            assert tk.tile_form(sh, big, 1, dtype, (16, 128)) == (
                "tile", (16, 128), (1, 1, v, v), v)


def test_normalize_and_wide_reach_take_the_per_step_form():
    """normalize needs the whole grid's norm in every step; a reach of 40
    grows the 32 x 128 tile to 112 x 208 at 1 step and 272 x 368 at 3,
    past twice the tile; a reach of 2 rows at 3 steps grows the 16 x 128
    tile past twice its size (28 x 152) but not the 32 x 128 one."""
    gs = (1024, 1024)
    lap = [(0, 0), (1, 0), (1023, 0), (0, 1), (0, 1023)]
    for n_steps in (1, 10):
        form = tk.stencil_form(lap, gs, n_steps, "normalize", F32)
        assert form == ("step", None, None, 4)
        assert tk.stencil_launches("normalize", n_steps, form.form) == (
            2 * n_steps + 1)
    wide = lap + [(40, 0), (1024 - 40, 0), (0, 40), (0, 1024 - 40)]
    assert tk.stencil_reach(wide, gs) == (40, 40, 40, 40)
    assert tk.stencil_form(wide, gs, 1, "plain", F32).form == "step"
    form = tk.stencil_form(wide, gs, 3, "plain", F32)
    assert form.form == "step"
    assert tk.stencil_launches("plain", 3, form.form) == 3
    two = lap + [(2, 0), (1022, 0)]
    assert tk.stencil_form(two, gs, 3, "affine", F32) == (
        "tile", (32, 128), (6, 6, 12, 12), 4)


def test_calls_take_their_form_once():
    """`StencilCall.form` is chosen at construction; the users' calls and
    the transposed SpMV's take theirs (the 64^2 Laplacian)."""
    from gnnla_tpu_torch.problems import laplacian_2d

    A, gs = laplacian_2d(64, device="cpu").eliminate_zeros(), (64, 64)
    spmv = tk.make_stencil_spmv(A, gs, n_steps=3)
    assert spmv._call.form.form == "tile" and spmv.form_t.form == "tile"
    assert spmv.form_t.halo == spmv._call.form.halo  # a symmetric reach
    assert tk.make_stencil_jacobi(A, gs, n_iters=3)._call.form == (
        "tile", (16, 64), (3, 3, 12, 12), 4)
    assert tk.make_stencil_residual(A, gs)._call.form.form == "step"
    assert tk.make_stencil_spmv(A, gs, 1)._call.form.form == "step"
    assert tk.make_stencil_power(A, gs)._call.form.form == "step"


# --------------------------------------------------- the walk, bitwise
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["plain", "affine"])
@pytest.mark.parametrize("n_steps", [1, 2, 3, 4])
@pytest.mark.parametrize("shape,tile,vec_w,reach", [
    ((13, 10), (5, 4), 1, 1),    # tiles cut 13 rows and 10 columns unevenly
    ((9, 24), (4, 8), 4, 1),     # 4 columns a thread: halo rounded to 4
    ((9, 24), (4, 8), 8, 2),     # 8 columns a thread, a reach of 2
    ((3, 4), (2, 4), 4, 1),      # a grid smaller than its halo
    ((5, 3), (2, 2), 1, 2),      # both: the halo wraps more than once
], ids=["13x10", "9x24-v4", "9x24-v8-reach2", "3x4", "5x3-reach2"])
def test_tile_walk_is_the_plain_version_bitwise(shape, tile, vec_w, reach,
                                                n_steps, mode, dtype):
    shifts, taps, x, c = random_stencil(shape, dtype, n_steps, reach)
    cc = c if mode == "affine" else None
    got = tile_walk(taps, shifts, x, n_steps, mode, cc, tile, vec_w)
    want = stencil_apply_plain(taps, shifts, x, n_steps, mode, cc)
    assert torch.equal(got, want)


def test_tile_walk_in_the_form_stencil_form_picks():
    """A 64 x 64 grid in the form the geometric cycle's calls take there:
    the 3-step Jacobi on the 16 x 64 tile with V = 4."""
    shifts, taps, x, c = random_stencil((64, 64), F32, 9)
    form = tk.stencil_form(shifts, (64, 64), 3, "affine", F32)
    assert form == ("tile", (16, 64), (3, 3, 12, 12), 4)
    got = tile_walk(taps, shifts, x, 3, "affine", c, form.tile, form.vec)
    assert torch.equal(got, stencil_apply_plain(taps, shifts, x, 3,
                                                "affine", c))


# ------------------------------------------------------ against the JAX
@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("case", ["lap20", "nonsym20", "periodic8", "fem12"])
def test_tile_walk_matches_jax(case, n_steps, interpret_mode):
    """The walk of the SpMV's, the Jacobi's and the residual's taps
    against `PallasStencilSpMV`, `PallasStencilJacobi` and
    `PallasStencilResidual`, on a tile that cuts the grid unevenly."""
    A_j, gs = grid_operator(case)
    A = carry(A_j)
    n = A_j.n_rows
    x, b = vec(n, 1), vec(n, 2)
    x2, b2 = (torch.from_numpy(v).reshape(gs) for v in (x, b))
    tile, v = (7, 8), 4
    s_t = tk.make_stencil_spmv(A, gs, n_steps)
    got = tile_walk(s_t.taps, s_t.shifts, x2, n_steps, "plain", None, tile,
                    v)
    assert_close(got.reshape(-1),
                 jps.make_stencil_spmv(A_j, gs, n_steps).matvec_n(
                     jnp.asarray(x)))
    jac = tk.make_stencil_jacobi(A, gs, omega=0.7, n_iters=n_steps)
    c = (jac.omega * b2 / jac._d2).float()
    got = tile_walk(jac.taps, jac._call.shifts, x2, n_steps, "affine", c,
                    tile, v)
    want = jps.make_stencil_jacobi(A_j, gs, omega=0.7, n_iters=n_steps)
    assert_close(got.reshape(-1), want.smooth(jnp.asarray(b),
                                              jnp.asarray(x)))
    res = tk.make_stencil_residual(A, gs)
    got = tile_walk(res.taps, res._call.shifts, x2, 1, "affine", b2, tile, v)
    assert_close(got.reshape(-1), jps.make_stencil_residual(A_j, gs).residual(
        jnp.asarray(b), jnp.asarray(x)))


def test_bf16_tile_walk_matches_jax(interpret_mode):
    """bf16 taps, widened exactly, 3 fused SpMV steps on a 24 x 24 grid
    (8 columns a thread)."""
    A = j_laplacian_2d(24).eliminate_zeros()
    rows, cols, _ = A.host_coo()
    v = np.where(rows == cols, -4.0,
                 np.random.default_rng(3).uniform(0.5, 1.5, rows.size))
    A_j, gs = JSparse.from_coo(rows, cols, v, A.shape), (24, 24)
    s_t = tk.make_stencil_spmv(carry(A_j), gs, 3, tap_dtype=BF16)
    x = vec(A_j.n_rows, 4)
    got = tile_walk(s_t.taps, s_t.shifts, torch.from_numpy(x).reshape(gs),
                    3, "plain", None, (16, 24), 8)
    want = jps.make_stencil_spmv(A_j, gs, 3, tap_dtype=jnp.bfloat16)
    assert_close(got.reshape(-1), want.matvec_n(jnp.asarray(x)))
