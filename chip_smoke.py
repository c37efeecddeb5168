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
Then the `{"kernels": [...]}` line, and last `{"ok": true, "device": ...}`.
Any failed check raises, and the script exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from gnnla_tpu_torch import _build, native_ext
from gnnla_tpu_torch.models.vcycle import (setup_twogrid, setup_with_dia,
                                           setup_with_stream_p, solve)
from gnnla_tpu_torch.ops.dia_spmv import DiaKernelOperator
from gnnla_tpu_torch.ops.stream_op import RectStreamOperator
from gnnla_tpu_torch.problems import laplacian_2d

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
N_GRID = 1024
N_CYCLES = 5
RTOL = 1e-5


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


def compare(got: torch.Tensor, want: torch.Tensor, what: str) -> dict:
    err = (got - want).abs()
    scale = float(want.abs().max())
    ok = bool((err <= RTOL * want.abs() + RTOL * scale).all())
    out = dict(what=what, max_abs_err=float(err.max()),
               max_rel_err=float(err.max()) / scale if scale else 0.0)
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: kernel disagrees with plain {out}")
    return out


def main() -> int:
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
            coo = getattr(plain, key)
            lib_csr = (coo.row_ptr, coo.cols, coo.vals, coo.shape)
        else:
            csr = kern
            y = torch.empty(csr.shape[0], device=dev)

            def raw(csr=csr, xin=xin, y=y):
                lib.csr_spmv_f32(csr.row_ptr.data_ptr(),
                                 csr.cols.data_ptr(), csr.vals.data_ptr(),
                                 csr.shape[0], xin.data_ptr(),
                                 y.data_ptr(), stream)
            r_, c_ = csr.shape
            bytes_moved = csr.nnz * 8 + (r_ + 1) * 4 + c_ * 4 + r_ * 4
            flops = 2 * csr.nnz
            kname, src, rep = ("csr_spmv", "gnnla_tpu_torch/csrc/csr_spmv.cu",
                               "gnnla_tpu/ops/pallas_stream.py:479")
            lib_csr = (csr.row_ptr, csr.cols, csr.vals, csr.shape)
        with warnings.catch_warnings():  # beta-state notice of sparse CSR
            warnings.simplefilter("ignore")
            lib_mat = torch.sparse_csr_tensor(
                lib_csr[0].long(), lib_csr[1].long(), lib_csr[2],
                size=lib_csr[3])
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

    # profiler: device time by kernel over 3 cycles. The first profile
    # of a process starts the tracer and is thrown away.
    from torch.profiler import ProfilerActivity, profile
    for cycles in (1, 3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            solve(fast, b, x0, n_cycles=cycles)
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
    busy_ms = sum(r[2] for r in rows)
    emit(dict(phase="profile", device_busy_ms_per_cycle=busy_ms,
              idle_share=1.0 - busy_ms / ms_cycle,
              top_kernels_per_cycle=[
                  dict(kernel=k, launches=c, ms=m) for k, c, m in rows[:12]]))

    emit({"kernels": kernels})
    # count: the cards visible to the process; the run drives card 0 only
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
