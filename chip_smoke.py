"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each on stdout:
  1. device  — requires CUDA; the card's name, count, CUDA version, and
               nvidia-smi's `name, power.limit` line.
  2. build   — builds the kernels from gnnla_tpu_torch/csrc (nvcc, sm_90a)
               and prints the build seconds and ptxas register, shared
               memory and spill lines.
  3. setup   — the 1024^2 FD Laplacian, `setup_twogrid(theta=0.25, cljp,
               seed=0)`, `setup_with_dia(kernel=True)`, `setup_with_stream_p`;
               asserts A and Ac are on kernel K1 and P on kernel K2.
  4. kernels — each kernel's wrapper against its plain PyTorch version on
               the card, at the main path's shapes (rtol 1e-5, atol
               1e-5 * max|y|: the two sum in different orders in f32).
  5. solve   — 5 cycles of `solve`; the residual must fall every cycle;
               the launch counts must be exactly 11 K1 and 2 K2 launches
               per cycle; x must match the plain path on the card (max
               error <= 1e-4 relative to max|x|); a 64^2 run must match
               the port's CPU path.
  6. times   — ms/cycle (CUDA events over 20 warm cycles); per kernel and
               shape the kernel, plain version and cuSPARSE (`library_ms`)
               times with the L2 cache flushed before each call, beside
               the memory-rate bound; the wrapper's and the raw launch's
               back-to-back, L2-warm times; peak device memory; a
               profiler breakdown of one cycle's device time and idle
               share.
The grid path (kernel K4, the fused stencil) on the same 1024^2 operator:
  7. grid_setup   — the alternating setup, `GeometricVCycle(setup=...)` and
                    `AutoTwoGrid` on the CLJP setup of phase 3 (host
                    seconds); asserts the auto layout is "stencil" with a
                    plain DIA Ac and a COO P (no K1 or K2 launch).
  8. grid_kernels — K4 against its plain version on the card at the grid
                    path's shapes: plain on the 1024 x 512 Ac (one step),
                    affine Jacobi (3 steps) and residual (1 step) on 1024^2,
                    normalize (10 steps), and bf16-tap Jacobi. rtol 1e-5,
                    atol 1e-5 * max|y|; normalize n_steps * 64 * 2^-24
                    (see NORM_ULPS_PER_STEP).
  9. grid         — 5 `GeometricVCycle` cycles: the residual falls every
                    cycle; exactly 11 K4 launches per cycle (3 + 1 + 4 + 3);
                    x matches the generic cycle on the same alternating
                    setup on the plain COO path (1e-4 of max|x|); a 64^2
                    run matches the port's CPU path.
 10. auto         — 5 `AutoTwoGrid` (stencil) cycles: the residual falls
                    every cycle; exactly 7 K4 launches per cycle; x matches
                    phase 5's plain cycle (1e-4 of max|x|).
 11. grid_times   — ms/cycle of both (CUDA events over 20 warm cycles); per
                    K4 shape the flushed and L2-warm times, plain time,
                    bound, launches per cycle and, for the two one-step
                    shapes, one cuSPARSE call (`mat @ x`, `torch.addmv`
                    for the residual c - A x) checked against the kernel;
                    a profiler breakdown of one geometric cycle.
The stream leg of `AutoTwoGrid` (kernel K2 on a square RCM-ordered A):
 12. stream       — the 1024^2 Laplacian with its vertices shuffled; its
                    CLJP setup; `AutoTwoGrid` picks "stream". K2 on the
                    RCM-ordered CSR and its transpose against their plain
                    versions, matvec/rmatvec in caller order against the
                    plain COO operator (rtol 1e-5); 5 cycles: the residual
                    falls every cycle, exactly 7 K2 launches per cycle, x
                    matches the plain cycle (1e-4 of max|x|); ms/cycle,
                    the K2 row's times and a profile of one cycle.
Then the `{"kernels": [...]}` line, and last `{"ok": true, "device": ...}`.
Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from gnnla_tpu_torch import _build, native_ext
from gnnla_tpu_torch.models.geometric import GeometricVCycle
from gnnla_tpu_torch.models.vcycle import (AutoTwoGrid, setup_twogrid,
                                           setup_with_dia,
                                           setup_with_stream_p, solve)
from gnnla_tpu_torch.ops.dia import DIAOperator
from gnnla_tpu_torch.ops.dia_spmv import DiaKernelOperator
from gnnla_tpu_torch.ops.sparse import SparseOperator
from gnnla_tpu_torch.ops.stencil_kernel import (make_stencil_jacobi,
                                                make_stencil_power,
                                                stencil_args,
                                                stencil_buffers,
                                                stencil_launches)
from gnnla_tpu_torch.ops.stream_op import RectStreamOperator, StreamOperator
from gnnla_tpu_torch.problems import laplacian_2d

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
N_GRID = 1024
N_CYCLES = 5
RTOL = 1e-5
# normalize mode: per step, kernel and plain version each sum ||T x||^2 in
# a tree of depth < 32 (relative error < 32 * 2^-24 each) and take
# 1/sqrt within a few ulp; the scales they apply differ by less than
# 64 * 2^-24, and those differences add over the steps.
NORM_ULPS_PER_STEP = 64
K2_ROW = ("csr_spmv", "gnnla_tpu_torch/csrc/csr_spmv.cu",
          "gnnla_tpu/ops/pallas_stream.py:479")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of fn by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_cold(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean ms of one call of fn with the L2 cache flushed before it. The
    flush reads a buffer larger than L2, so it leaves no dirty lines for
    the timed call to write back; it is enqueued first, so the host
    enqueues the timed call while the device is still busy and no host
    gap lands inside the events."""
    fn()
    total = 0.0
    for _ in range(iters):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound(bytes_moved: float, flops: float):
    """(ms, "bytes"|"operations"): the least time for the work."""
    t_b, t_o = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def require(cond: bool, what) -> None:
    """A check that stays under `python -O` (unlike assert)."""
    if not cond:
        raise AssertionError(what)


def compare(got: torch.Tensor, want: torch.Tensor, what: str,
            rtol: float = RTOL) -> dict:
    err = (got - want).abs()
    scale = float(want.abs().max())
    ok = bool((err <= rtol * want.abs() + rtol * scale).all())
    out = dict(what=what, max_abs_err=float(err.max()),
               max_rel_err=float(err.max()) / scale if scale else 0.0)
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: kernel disagrees with plain {out}")
    return out


def csr_tensor(op) -> torch.Tensor:
    """torch's sparse CSR view of an operator's CSR arrays (cuSPARSE)."""
    with warnings.catch_warnings():  # beta-state notice of sparse CSR
        warnings.simplefilter("ignore")
        return torch.sparse_csr_tensor(op.row_ptr.long(), op.cols.long(),
                                       op.vals, size=op.shape)


def csr_raw(lib, csr, x: torch.Tensor):
    """(raw launch of K2 on the CsrSpMV `csr` and x, bytes, flops): each
    input read once, the output written once."""
    y = torch.empty(csr.shape[0], device=x.device)
    stream = torch.cuda.current_stream().cuda_stream

    def raw():
        lib.csr_spmv_f32(csr.row_ptr.data_ptr(), csr.cols.data_ptr(),
                         csr.vals.data_ptr(), csr.shape[0], x.data_ptr(),
                         y.data_ptr(), stream)
    r_, c_ = csr.shape
    return raw, csr.nnz * 8 + (r_ + 1) * 4 + c_ * 4 + r_ * 4, 2 * csr.nnz


def library_call(op, x2d: torch.Tensor, c2d=None):
    """One PyTorch call computing a one-step K4 row's function on op's CSR:
    y = op x (plain), or y = c - op x (the affine residual, whose taps are
    -op), with `torch.addmv` on cuSPARSE. A yardstick only."""
    mat, x = csr_tensor(op), x2d.reshape(-1)
    if c2d is None:
        return lambda: mat @ x
    c = c2d.reshape(-1)
    return lambda: torch.addmv(c, mat, x, alpha=-1)


def profile_cycles(run_cycles) -> dict:
    """Device time by kernel per cycle over 3 cycles of run_cycles(n).
    The first profile of a process starts the tracer and is thrown away."""
    from torch.profiler import ProfilerActivity, profile
    for cycles in (1, 3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_cycles(cycles)
            torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        # kernels are the events on the CUDA side; their self time is the
        # device time (profiler attribute names vary across releases)
        if getattr(ev, "device_type", None) != \
                torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((ev.key[:60], ev.count / 3, dev_us / 3e3))
    rows.sort(key=lambda r: -r[2])
    return dict(device_busy_ms_per_cycle=sum(r[2] for r in rows),
                top_kernels_per_cycle=[
                    dict(kernel=k, launches=c, ms=m) for k, c, m in rows[:12]])


def grid_path(A, plain, b, x_plain, flush, smi) -> list:
    """Phases 7-11 (the grid path on kernel K4); returns the K4 rows of
    the kernels line, one per shape the grid path launches."""
    dev = b.device
    n = A.n_rows
    gs = (N_GRID, N_GRID)

    # ------------------------------------------------------ grid_setup
    t0 = time.perf_counter()
    alt = setup_twogrid(A, theta=0.25, splitting="alternating")
    t_alt = time.perf_counter() - t0
    t0 = time.perf_counter()
    geo = GeometricVCycle(A, gs, setup=alt)
    t_geo = time.perf_counter() - t0
    t0 = time.perf_counter()
    auto = AutoTwoGrid(plain)
    t_auto = time.perf_counter() - t0
    require(auto.layout == "stencil", (auto.layout, auto.why))
    sv = auto._stencil
    # Ac is the plain DIA twin and P the COO P: the stencil cycle launches
    # no K1 or K2, as in the JAX package
    require(type(sv.setup.Ac) is DIAOperator, type(sv.setup.Ac))
    require(type(sv.setup.P) is SparseOperator, type(sv.setup.P))
    ac_taps = geo._ac_call.taps
    emit(dict(phase="grid_setup", alternating_setup_s=t_alt,
              geometric_build_s=t_geo, auto_build_s=t_auto,
              auto_layout=auto.layout, auto_why=auto.why,
              ac_grid=list(ac_taps.shape[1:]), ac_K=ac_taps.shape[0],
              ac_nnz=alt.Ac.nnz, p_offset_classes=len(geo._p_offsets),
              jacobi_K=geo._pre.taps.shape[0],
              residual_K=geo._res.taps.shape[0],
              auto_dia_Ac_K=len(sv.setup.Ac.offsets)))

    # ----------------------------------------- K4 vs its plain version
    gen = np.random.default_rng(11)

    def grid_vec(shape):
        return torch.from_numpy(
            gen.standard_normal(shape).astype(np.float32)).to(dev)

    x_f, c_f = grid_vec(gs), grid_vec(gs)
    x_c = grid_vec(tuple(ac_taps.shape[1:]))
    power = make_stencil_power(A, gs, n_iters=10)
    jac16 = make_stencil_jacobi(A, gs, omega=0.7, n_iters=3, diag=alt.diag,
                                tap_dtype=torch.bfloat16)
    shapes = {  # row -> (K4 call, x, c, operator of the one-call library
        #        yardstick); the first three are the geometric cycle's own
        "Ac_plain": (geo._ac_call, x_c, None, alt.Ac),
        "jacobi_affine": (geo._pre._call, x_f, c_f, None),
        "residual_affine": (geo._res._call, x_f, c_f, A),
        "power_normalize": (power._call, x_f, None, None),
        "jacobi_affine_bf16": (jac16._call, x_f, c_f, None),
    }
    errs, outs = {}, {}
    for key, (call, xin, cin, _) in shapes.items():
        rtol = (call.n_steps * NORM_ULPS_PER_STEP * 2.0 ** -24
                if call.mode == "normalize" else RTOL)
        got = call(xin, cin)
        want = call.plain(xin, cin)
        torch.cuda.synchronize()
        outs[key] = got
        errs[key] = dict(compare(got, want, key, rtol), rtol=rtol,
                         mode=call.mode, n_steps=call.n_steps,
                         tap_dtype=str(call.taps.dtype),
                         K=call.taps.shape[0],
                         bitwise_equal=bool(torch.equal(got, want)))
    emit(dict(phase="grid_kernels", atol="rtol * max|y|",
              results=list(errs.values())))

    # ------------------------------------------------------------ grid
    x = torch.zeros(n, device=dev)
    calls = geo.kernel_calls()
    for call in calls:
        call.launches = 0
    res = [float(torch.linalg.vector_norm(b - A.matvec(x)))]
    for _ in range(N_CYCLES):
        x = geo.run(b, x)
        # the plain COO A (index_add_) reads the residual: no K4 launch
        res.append(float(torch.linalg.vector_norm(b - A.matvec(x))))
    torch.cuda.synchronize()
    launches = {"Ac_plain": geo._ac_call.launches,
                "jacobi_affine": geo._pre._call.launches,
                "residual_affine": geo._res._call.launches}
    require(all(r1 < r0 for r0, r1 in zip(res, res[1:])), res)
    want_launches = {"Ac_plain": 4 * N_CYCLES, "jacobi_affine": 6 * N_CYCLES,
                     "residual_affine": N_CYCLES}
    require(launches == want_launches, (launches, want_launches))
    require(sum(c.launches for c in calls) == 11 * N_CYCLES, launches)
    require(x.shape == (n,) and bool(torch.isfinite(x).all()),
            "x must be finite, of shape [n]")
    x_gen = solve(alt, b, torch.zeros(n, device=dev), n_cycles=N_CYCLES)
    rel = float((x - x_gen).abs().max() / x_gen.abs().max())
    require(rel <= 1e-4, rel)
    # small input: the card's kernel path against the port's CPU path
    b_s = np.random.default_rng(5).standard_normal(64 * 64).astype(
        np.float32)

    def small(device):
        g = GeometricVCycle(laplacian_2d(64, device=device).eliminate_zeros(),
                            (64, 64))
        bb = torch.from_numpy(b_s).to(device)
        y = torch.zeros_like(bb)
        for _ in range(4):
            y = g.run(bb, y)
        return y.cpu()

    x_s, x_h = small(dev), small("cpu")
    rel_small = float((x_s - x_h).abs().max() / x_h.abs().max())
    require(rel_small <= 2e-5, rel_small)
    emit(dict(phase="grid", cycles=N_CYCLES, residual_norms=res,
              launches=launches, k4_launches_per_cycle=sum(
                  launches.values()) // N_CYCLES,
              rel_err_vs_generic_plain_cycle=rel,
              rel_err_64sq_vs_cpu=rel_small))

    # ------------------------------------------------------------ auto
    x = torch.zeros(n, device=dev)
    a_calls = sv.kernel_calls()
    for call in a_calls:
        call.launches = 0
    res_a = [float(torch.linalg.vector_norm(b - A.matvec(x)))]
    for _ in range(N_CYCLES):
        x = auto.run(b, x)
        res_a.append(float(torch.linalg.vector_norm(b - A.matvec(x))))
    torch.cuda.synchronize()
    a_launches = {"jacobi_affine": sv._pre._call.launches,
                  "residual_affine": sv._res._call.launches}
    require(all(r1 < r0 for r0, r1 in zip(res_a, res_a[1:])), res_a)
    require(a_launches == {"jacobi_affine": 6 * N_CYCLES,
                           "residual_affine": N_CYCLES}, a_launches)
    require(bool(torch.isfinite(x).all()), "auto x must be finite")
    rel_a = float((x - x_plain).abs().max() / x_plain.abs().max())
    require(rel_a <= 1e-4, rel_a)
    emit(dict(phase="auto", layout=auto.layout, cycles=N_CYCLES,
              residual_norms=res_a, launches=a_launches,
              k4_launches_per_cycle=sum(a_launches.values()) // N_CYCLES,
              rel_err_vs_plain_cycle=rel_a))

    # ------------------------------------------------------ grid_times
    x0 = torch.zeros(n, device=dev)
    ms_geo = cuda_ms(lambda: geo.run(b, x0), iters=20)
    ms_auto = cuda_ms(lambda: auto.run(b, x0), iters=20)
    ms_gen = cuda_ms(lambda: solve(alt, b, x0, n_cycles=1), iters=3,
                     warmup=1)
    xc = torch.zeros(sv.setup.Ac.n, device=dev)
    ms_auto_ac = cuda_ms(lambda: sv.setup.Ac.matvec(xc), iters=5, warmup=1)
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    rows, off_path, warm, lib_errs, k4_ms_cycle = [], [], {}, {}, 0.0
    for key, (call, xin, cin, lib_op) in shapes.items():
        taps = call.taps
        bufs = stencil_buffers(xin, call.n_steps, call.mode)
        args = stencil_args(taps, call.shifts_dev, xin, call.n_steps,
                            call.mode, cin, *bufs)

        def raw(args=args):
            lib.stencil_f32(*args, stream)
        k, pts = taps.shape[0], xin.numel()
        # each input read once, the output written once per fused call
        bytes_moved = (k * taps.element_size()
                       + 4 * (2 + (cin is not None))) * pts
        flops = call.n_steps * pts * (2 * k + (call.mode == "affine")
                                      + 3 * (call.mode == "normalize"))
        bound_ms, bound_by = bound(bytes_moved, flops)
        library_ms = None
        if lib_op is not None:  # the one-step rows: one cuSPARSE call
            lib_fn = library_call(lib_op, xin, cin)
            lib_errs[key] = compare(lib_fn(), outs[key].reshape(-1),
                                    f"library yardstick of {key}")
            library_ms = cuda_ms_cold(lib_fn, 20, flush)
        row = dict(
            name=f"stencil[{key}]", route="cuda",
            source="gnnla_tpu_torch/csrc/stencil.cu",
            replaces="gnnla_tpu/ops/pallas_stencil.py:126",
            launches=launches.get(key, 0),
            max_abs_err=errs[key]["max_abs_err"],
            ms=cuda_ms_cold(raw, 20, flush),
            plain_ms=cuda_ms_cold(lambda: call.plain(xin, cin), 5, flush),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
        per_call = stencil_launches(call.mode, call.n_steps)
        # back to back, L2 warm: the raw launch (median of 5 windows) and
        # the wrapper; the profiler's device time of one call, which no
        # host delay can inflate
        warm[key] = dict(raw_ms=float(np.median([cuda_ms(raw, iters=20)
                                                 for _ in range(5)])),
                         wrapper_ms=cuda_ms(lambda: call(xin, cin),
                                            iters=50),
                         device_ms_per_call=profile_cycles(
                             lambda c: [raw() for _ in range(c)])[
                                 "device_busy_ms_per_cycle"],
                         launches_per_call=per_call,
                         calls_per_cycle=launches.get(key, 0) // (
                             N_CYCLES * per_call))
        (rows if key in launches else off_path).append(row)
        k4_ms_cycle += row["ms"] * warm[key]["calls_per_cycle"]
    prof = profile_cycles(
        lambda c: [geo.run(b, x0) for _ in range(c)])
    emit(dict(phase="grid_times", ms_per_cycle_geometric=ms_geo,
              ms_per_cycle_auto_stencil=ms_auto,
              ms_per_cycle_generic_alternating_plain=ms_gen,
              auto_plain_dia_Ac_apply_ms=ms_auto_ac,
              k4_flushed_ms_per_geometric_cycle=k4_ms_cycle,
              l2_warm=warm, off_main_path=off_path,
              library_vs_kernel=lib_errs,
              geometric_device_busy_ms_per_cycle=prof[
                  "device_busy_ms_per_cycle"],
              geometric_idle_share=1.0 - prof["device_busy_ms_per_cycle"]
              / ms_geo,
              geometric_top_kernels_per_cycle=prof["top_kernels_per_cycle"],
              nvidia_smi=smi))
    return rows


def stream_path(A, flush, smi) -> list:
    """Phase 12 (`AutoTwoGrid`'s "stream" leg: A on kernel K2 in RCM order,
    perm/iperm gathers around it); returns the K2 row of that leg."""
    dev, n = A.device, A.n_rows
    rows, cols, vals = A.host_coo()
    # the same Laplacian with its vertices shuffled: no grid, no band, so
    # the stencil and DIA probes refuse it and RCM restores a narrow band
    new = np.argsort(np.random.default_rng(0).permutation(n))
    A_p = SparseOperator.from_coo(new[rows], new[cols], vals, A.shape,
                                  device=dev)
    t0 = time.perf_counter()
    setup_p = setup_twogrid(A_p, theta=0.25, splitting="cljp", seed=0)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    auto = AutoTwoGrid(setup_p)
    t_auto = time.perf_counter() - t0
    require(auto.layout == "stream", (auto.layout, auto.why))
    S = auto.setup.A
    require(isinstance(S, StreamOperator) and S.perm is not None, type(S))

    # K2 both ways against plain versions on the card: the kernel-order
    # CSR against its plain version, and the caller-order matvec/rmatvec
    # (K2 between the perm/iperm gathers) against the plain COO operator
    xr = torch.from_numpy(np.random.default_rng(13).standard_normal(
        n).astype(np.float32)).to(dev)
    xk = xr[S.perm].contiguous()
    errs = {"A_rcm": compare(S.fwd(xk), S.fwd.plain(xk), "A_rcm"),
            "A_rcm_T": compare(S.bwd(xk), S.bwd.plain(xk), "A_rcm_T"),
            "matvec": compare(S.matvec(xr), A_p.matvec(xr), "matvec"),
            "rmatvec": compare(S.rmatvec(xr), A_p.rmatvec(xr), "rmatvec")}

    b = torch.from_numpy(
        np.random.default_rng(3).standard_normal(n).astype(np.float32)
    ).to(dev)
    x = torch.zeros(n, device=dev)
    S.fwd.launches = S.bwd.launches = 0
    res = [float(torch.linalg.vector_norm(b - A_p.matvec(x)))]
    for _ in range(N_CYCLES):
        x = auto.run(b, x)
        # the plain COO A_p (index_add_) reads the residual: no K2 launch
        res.append(float(torch.linalg.vector_norm(b - A_p.matvec(x))))
    torch.cuda.synchronize()
    launches = {"A_rcm": S.fwd.launches, "A_rcm_T": S.bwd.launches}
    require(all(r1 < r0 for r0, r1 in zip(res, res[1:])), res)
    # 3 pre + 3 post Jacobi sweeps and the residual; the cycle never
    # applies A^T
    require(launches == {"A_rcm": 7 * N_CYCLES, "A_rcm_T": 0}, launches)
    require(bool(torch.isfinite(x).all()), "stream x must be finite")
    x_plain = solve(setup_p, b, torch.zeros(n, device=dev),
                    n_cycles=N_CYCLES)
    rel = float((x - x_plain).abs().max() / x_plain.abs().max())
    require(rel <= 1e-4, rel)

    x0 = torch.zeros(n, device=dev)
    ms_cycle = cuda_ms(lambda: auto.run(b, x0), iters=20)
    ms_plain = cuda_ms(lambda: solve(setup_p, b, x0, n_cycles=1), iters=3,
                       warmup=1)
    prof = profile_cycles(lambda c: [auto.run(b, x0) for _ in range(c)])
    raw, bytes_moved, flops = csr_raw(_build.load(), S.fwd, xk)
    lib_mat = csr_tensor(S.fwd)
    lib_mat @ xk
    bound_ms, bound_by = bound(bytes_moved, flops)
    row = dict(
        name="csr_spmv[A_rcm]", route="cuda", source=K2_ROW[1],
        replaces=K2_ROW[2], launches=launches["A_rcm"],
        max_abs_err=errs["A_rcm"]["max_abs_err"],
        ms=cuda_ms_cold(raw, 20, flush),
        plain_ms=cuda_ms_cold(lambda: S.fwd.plain(xk), 5, flush),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=cuda_ms_cold(lambda: lib_mat @ xk, 20, flush))
    emit(dict(phase="stream", setup_twogrid_s=t_setup, auto_build_s=t_auto,
              layout=auto.layout, why=auto.why, n=n, nnz=S.nnz,
              results=list(errs.values()), cycles=N_CYCLES,
              residual_norms=res, launches=launches,
              rel_err_vs_plain_cycle=rel, ms_per_cycle=ms_cycle,
              ms_per_cycle_plain_path=ms_plain,
              k2_raw_l2_warm_ms=cuda_ms(raw, iters=50),
              device_busy_ms_per_cycle=prof["device_busy_ms_per_cycle"],
              idle_share=1.0 - prof["device_busy_ms_per_cycle"] / ms_cycle,
              top_kernels_per_cycle=prof["top_kernels_per_cycle"],
              nvidia_smi=smi))
    return [row]


def main() -> int:
    # no cyclic-garbage collection pause may land inside a timed window;
    # reference counting still frees every tensor of this short run
    gc.disable()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    emit(dict(phase="device", name=name, count=torch.cuda.device_count(),
              cuda=torch.version.cuda, torch=torch.__version__,
              nvidia_smi=smi))

    lib = _build.load(force=True)
    info = _build.build_info()
    emit(dict(phase="build", seconds=info["seconds"], path=info["path"],
              ptxas=info["ptxas"]))

    # ---------------------------------------------------------- setup
    t0 = time.perf_counter()
    A = laplacian_2d(N_GRID, device=dev).eliminate_zeros()
    plain = setup_twogrid(A, theta=0.25, splitting="cljp", seed=0)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    fast = setup_with_stream_p(setup_with_dia(plain, kernel=True))
    t_swap = time.perf_counter() - t0
    require(isinstance(fast.A, DiaKernelOperator), type(fast.A))
    require(isinstance(fast.Ac, DiaKernelOperator), type(fast.Ac))
    require(isinstance(fast.P, RectStreamOperator), type(fast.P))
    n, nc = fast.P.shape
    emit(dict(phase="setup", native_cljp=native_ext.available(),
              setup_twogrid_s=t_setup, swap_s=t_swap, n=n, nc=nc,
              A_nnz=A.nnz, A_K=len(fast.A.offsets), Ac_nnz=plain.Ac.nnz,
              Ac_K=len(fast.Ac.offsets),
              Ac_max_abs_offset=max(abs(o) for o in fast.Ac.offsets),
              P_nnz=fast.P.nnz))

    # ------------------------------------------- kernel vs plain version
    gen = np.random.default_rng(7)
    x_f = torch.from_numpy(gen.standard_normal(n).astype(np.float32)).to(dev)
    x_c = torch.from_numpy(gen.standard_normal(nc).astype(np.float32)).to(dev)
    shapes = {  # name -> (wrapper, plain version, input)
        "A": (fast.A.matvec, fast.A.plain().matvec, x_f),
        "Ac": (fast.Ac.matvec, fast.Ac.plain().matvec, x_c),
        "P": (fast.P.fwd, fast.P.fwd.plain, x_c),
        "Pt": (fast.P.bwd, fast.P.bwd.plain, x_f),
    }
    errs = {}
    for key, (kern, ref, x) in shapes.items():
        got = kern(x)
        want = ref(x)
        torch.cuda.synchronize()
        errs[key] = compare(got, want, key)
    emit(dict(phase="kernels", rtol=RTOL, atol=f"{RTOL} * max|y|",
              results=list(errs.values())))

    # ------------------------------------------------------- main path
    b = torch.from_numpy(
        np.random.default_rng(3).standard_normal(n).astype(np.float32)
    ).to(dev)
    x = torch.zeros(n, device=dev)
    counted = (fast.A, fast.Ac, fast.P.fwd, fast.P.bwd)
    for op in counted:
        op.launches = 0
    res = [float(torch.linalg.vector_norm(b - plain.A.matvec(x)))]
    for _ in range(N_CYCLES):
        x = solve(fast, b, x, n_cycles=1)
        # the plain COO A (index_add_) reads the residual: no kernel launch
        res.append(float(torch.linalg.vector_norm(b - plain.A.matvec(x))))
    torch.cuda.synchronize()
    launches = {"A": fast.A.launches, "Ac": fast.Ac.launches,
                "P": fast.P.fwd.launches, "Pt": fast.P.bwd.launches}
    require(all(r1 < r0 for r0, r1 in zip(res, res[1:])), res)
    want_launches = {"A": 7 * N_CYCLES, "Ac": 4 * N_CYCLES,
                     "P": N_CYCLES, "Pt": N_CYCLES}
    require(launches == want_launches, (launches, want_launches))
    x_plain = solve(plain, b, torch.zeros(n, device=dev), n_cycles=N_CYCLES)
    require(x.shape == (n,) and bool(torch.isfinite(x).all()),
            "x must be finite, of shape [n]")
    rel = float((x - x_plain).abs().max() / x_plain.abs().max())
    require(rel <= 1e-4, rel)

    # small input: the card's kernel path against the port's CPU path
    A_s = laplacian_2d(64, device=dev).eliminate_zeros()
    small = setup_with_stream_p(setup_with_dia(setup_twogrid(A_s),
                                               kernel=True))
    A_h = laplacian_2d(64, device="cpu").eliminate_zeros()
    b_s = np.random.default_rng(5).standard_normal(A_s.n_rows).astype(
        np.float32)
    x_s = solve(small, torch.from_numpy(b_s).to(dev),
                torch.zeros(A_s.n_rows, device=dev), n_cycles=4).cpu()
    x_h = solve(setup_twogrid(A_h), torch.from_numpy(b_s),
                torch.zeros(A_s.n_rows), n_cycles=4)
    rel_small = float((x_s - x_h).abs().max() / x_h.abs().max())
    require(rel_small <= 2e-5, rel_small)
    emit(dict(phase="solve", cycles=N_CYCLES, residual_norms=res,
              launches=launches, rel_err_vs_plain_path=rel,
              rel_err_64sq_vs_cpu=rel_small))

    # ----------------------------------------------------------- times
    torch.cuda.reset_peak_memory_stats()
    x0 = torch.zeros(n, device=dev)
    ms_cycle = cuda_ms(lambda: solve(fast, b, x0, n_cycles=1), iters=20)
    ms_cycle_plain = cuda_ms(lambda: solve(plain, b, x0, n_cycles=1),
                             iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated()

    flush = torch.ones(64 * 2 ** 20, device=dev)  # 256 MB > the 50 MB L2
    stream = torch.cuda.current_stream().cuda_stream
    kernels, warm = [], {}
    for key, (kern, ref, xin) in shapes.items():
        if key in ("A", "Ac"):
            op = getattr(fast, key)
            k, m = op.diags.shape
            y = torch.empty(m, device=dev)

            def raw(op=op, k=k, m=m, xin=xin, y=y):
                lib.dia_spmv_f32(op.diags.data_ptr(),
                                 op.offsets_dev.data_ptr(), k, m,
                                 xin.data_ptr(), y.data_ptr(), stream)
            bytes_moved = (k * m + 2 * m) * 4 + 4 * k
            flops = 2 * k * m
            kname, src, rep = ("dia_spmv", "gnnla_tpu_torch/csrc/dia_spmv.cu",
                               "gnnla_tpu/ops/pallas_spmv.py:41")
            lib_mat = csr_tensor(getattr(plain, key))
        else:
            raw, bytes_moved, flops = csr_raw(lib, kern, xin)
            kname, src, rep = K2_ROW
            lib_mat = csr_tensor(kern)
        lib_mat @ xin
        bound_ms, bound_by = bound(bytes_moved, flops)
        kernels.append(dict(
            name=f"{kname}[{key}]", route="cuda", source=src, replaces=rep,
            launches=launches[key], max_abs_err=errs[key]["max_abs_err"],
            ms=cuda_ms_cold(raw, 20, flush),
            plain_ms=cuda_ms_cold(lambda: ref(xin), 5, flush),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=cuda_ms_cold(lambda: lib_mat @ xin, 20, flush)))
        # back to back, L2 warm: the wrapper (checks + launch) and the raw
        # launch it wraps; the gap between them is the wrapper's host cost
        warm[key] = dict(wrapper_ms=cuda_ms(lambda: kern(xin), iters=50),
                         raw_ms=cuda_ms(raw, iters=50),
                         launches_per_cycle=launches[key] // N_CYCLES)
    emit(dict(phase="times", ms_per_cycle=ms_cycle,
              ms_per_cycle_plain_path=ms_cycle_plain,
              kernel_ms_per_cycle=sum(
                  kk["ms"] * warm[key]["launches_per_cycle"]
                  for key, kk in zip(shapes, kernels)),
              l2_warm=warm, peak_mem_bytes=peak, nvidia_smi=smi))

    prof = profile_cycles(lambda c: solve(fast, b, x0, n_cycles=c))
    emit(dict(phase="profile", device_busy_ms_per_cycle=prof[
        "device_busy_ms_per_cycle"],
        idle_share=1.0 - prof["device_busy_ms_per_cycle"] / ms_cycle,
        top_kernels_per_cycle=prof["top_kernels_per_cycle"]))

    kernels += grid_path(A, plain, b, x_plain, flush, smi)
    kernels += stream_path(A, flush, smi)
    emit({"kernels": kernels})
    # count: the cards visible to the process; the run drives card 0 only
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
