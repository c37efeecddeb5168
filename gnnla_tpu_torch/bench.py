"""Benchmark: SpMV message-passing throughput and composed-solver timings
on the card — the twin of the JAX repository's `bench.py`.

    python -m gnnla_tpu_torch.bench [n_grid] [n_iters] [--cpu]

n_grid (default 2048) is the side of the FD Laplacian of the spmv
section (the solver sections take max(64, n_grid // 2)); n_iters
(default 1000) is the applies its paths are timed over. The headline is
the metric BASELINE.json names: edges/s on SpMV message passing, the best
spmv path on the n_grid^2 Laplacian; `vs_baseline` divides it by scipy's
CSR SpMV on the host, the reference's execution model.

Sections, in the JAX bench's order (the same keys in `extra`):
  spmv      the 2D 5-point Laplacian scaled by 1/8: DIA shifts
            (`ops/dia.py`), kernel K1 in f32 and, where bit-exact, with
            bf16 diagonals (`ops/dia_spmv.py`), kernel K4 fused over
            n_iters steps with bf16 taps where exact
            (`ops/stencil_kernel.py`), the COO path (`ops/sparse.py`), a
            measured memory-bandwidth probe and roofline fractions.
  general   kernel K2 (`ops/stream_spmv.py::CsrSpMV`) on the k-NN-32 graph
            Laplacian of min(2^20, max(2^14, n_grid^2 / 4)) points in RCM
            order, with its error against scipy asserted in the same run.
  agg       4-way (min, mean, sum, max) aggregation on a 2^18-point k-NN-32
            graph: the ELL slot layout against segment reduction, and
            torch's scatter_reduce on the host (the reference's model).
  diffusion the dense, segment and band aggregation layouts on the
            min(1024, n_grid)^2 grid pattern, and a diffusion-GNN train
            step at reference scale, band and edge order.
  train     a trainable-Jacobi train step in the "dia" and "stencil" loss
            layouts; their losses must agree after the same steps.
  sharded   `parallel/hardware_check.py` on a world of one rank.
  solvers   two-grid cycles on the COO path, plain DIA, the fast setup (K1
            both levels, K2 for P), StencilVCycle and GeometricVCycle (K4);
            SA `mg_pcg` ms per iteration and iterations to 1e-8.
  convergence  per-cycle convergence factors, classical and SA, 64^2 up.
  spmm      kernel K3 (`CsrSpMV` on an [n, M] block, M = GNNLA_SPMM_RHS,
            default 8) on the general fixture, its error asserted.
  bsr       `ops/bsr.py::to_bsr` on the general fixture (capped at 2^17
            points, the same family) beside K2.

Timing: a warm-up apply, then CUDA events around n chained applies (the
host clock on the CPU). The events bracket the host's enqueue loop, so
where the host is slower than the card (per-call Python checks, the COO
and aggregation loops) the rate is the host's wall rate, as the JAX
bench's timing gave it; on the card each kernel path also gets a row in
`extra["kernels"]` with its device-busy ms from the profiler beside its
wall ms per call. Edges/s is nonzeros x applies / seconds.

Output: the cumulative line `{"metric": "spmv_edges_per_s", "value",
"unit", "vs_baseline", "extra"}` on stdout after every section and on
SIGTERM; progress on stderr. Knobs (environment): GNNLA_BENCH_SECTIONS
(comma-separated, default all ten), GNNLA_BENCH_BUDGET_S (default 3000:
a section whose estimate no longer fits is skipped and listed in
`skipped_sections`), GNNLA_SPMM_RHS.

No fallback: a failing health probe (kernel K5) stops the run; a section
that raises is listed in `failed_sections` and the run goes on to the
others; either way the process exits 1. The bf16 gates are a numerical
choice (bit-exactness on the matrix), and their verdicts are printed.

Keys whose TPU meaning has no counterpart here keep their names:
`warmup_seconds` is the fixture prebuild's seconds (no device warm-up:
the card has no tunnel); `general_graph_bytes_per_edge` counts K2's CSR
bytes as chip_smoke.py's K2 bound does (values and columns, row pointers,
row blocks, x and y, each once) and `general_graph_slot_waste` is 1.0 (CSR
stores no padding); `sharded_mosaic_ok` is 1 when the sharded families
ran and agreed on the device. The port adds `device`, the card's name
(or "host CPU, plain version"), the in-run errors of spmm and bsr
(`general_graph_spmm_relerr`, `general_graph_bsr_relerr`, which the JAX
bench asserts but does not record), and `kernels`, one row per kernel
path on the card.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time
import traceback
import warnings

import numpy as np
import torch

from gnnla_tpu_torch.scratch._common import say as log
from gnnla_tpu_torch.scratch._common import sync, where
# the JAX bench's k-NN-32 Laplacian (bench.py:383), bitwise
from gnnla_tpu_torch.scratch.bench_stream import knn_laplacian

# the H100 SXM's memory rate and f32 peak outside the tensor cores
# (NVIDIA data sheet), as chip_smoke.py's HBM_BYTES_PER_S and F32_FLOPS:
# the rooflines' denominators
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# a measured bandwidth outside this window is a timing fault, not a rate
BW_PLAUSIBLE = (1e10, 1.2 * HBM_BYTES_PER_S)
AGG_N = 1 << 18
BSR_N_CAP = 1 << 17
AGGS = ("min", "mean", "sum", "max")
K1_SRC = ("gnnla_tpu_torch/csrc/dia_spmv.cu",
          "gnnla_tpu/ops/pallas_spmv.py:41")
K2_SRC = ("gnnla_tpu_torch/csrc/csr_spmv.cu",
          "gnnla_tpu/ops/pallas_stream.py:479")
K3_SRC = ("gnnla_tpu_torch/csrc/csr_spmm.cu",
          "gnnla_tpu/ops/pallas_stream.py:635")
K4_SRC = ("gnnla_tpu_torch/csrc/stencil.cu",
          "gnnla_tpu/ops/pallas_stencil.py:126")
# Seconds per section, used only for the budget gate: the card's own from
# the full run `python -m gnnla_tpu_torch.bench` (2048, 1000) on one H100
# 80GB HBM3 at 700 W (PERF.md, PR 15, chip run 1), rounded up; the
# fixture prebuild before them took 17.8 s.
SECTION_EST = {
    "spmv": 20, "general": 2, "agg": 3, "diffusion": 5, "train": 1,
    "sharded": 2, "solvers": 15, "convergence": 2, "spmm": 1, "bsr": 3,
}
DEFAULT_SECTIONS = ("spmv,general,agg,diffusion,train,sharded,"
                    "solvers,convergence,spmm,bsr")


class Run:
    """The cumulative result: the best spmv rate, the CPU reference, the
    per-section numbers and the sections done."""

    def __init__(self):
        self.best = 0.0
        self.cpu = None
        self.extra = {}
        self.done = []

    def line(self) -> dict:
        extra = self.extra
        cpu = self.cpu
        if cpu is None:
            cpu = extra.get("general_graph_cpu_edges_per_s", 1.0)
        best = self.best
        if best == 0.0:
            best = extra.get("general_graph_edges_per_s", 0.0)
        extra["sections_done"] = list(self.done)
        return {"metric": "spmv_edges_per_s", "value": best,
                "unit": "edges/s",
                "vs_baseline": best / cpu if cpu else 0.0, "extra": extra}

    def emit(self) -> None:
        print(json.dumps(self.line()), flush=True)


# ------------------------------------------------------------------ timing
def seconds(fn, dev: torch.device):
    """(seconds, result) of fn(): CUDA events around it on the card (after
    the queue drained), the host clock on the CPU."""
    sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return time.perf_counter() - t0, out
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3, out


def chain(apply, x, n: int):
    for _ in range(n):
        x = apply(x)
    return x


def finite(x: torch.Tensor, what: str) -> None:
    s = float(x.float().sum())
    if not np.isfinite(s):
        raise AssertionError(f"{what}: chained iterate diverged ({s})")


def bench_rate(apply, x0, nnz: int, n_iters: int, dev: torch.device
               ) -> float:
    """edges/s of n_iters chained applies x <- apply(x) after one warm-up
    apply."""
    x = apply(x0)
    dt, x = seconds(lambda: chain(apply, x, n_iters), dev)
    finite(x, "bench")
    return nnz * n_iters / max(dt, 1e-12)


def bound(bytes_moved: float, flops: float):
    """(ms, "bytes"|"operations"): the least time the card could take."""
    t_b, t_o = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def csr_bytes(nnz: int, n_rows: int, n_cols: int, n_blocks: int) -> int:
    """K2's bytes, each input read once: values and columns, row pointers,
    row blocks, x; y written once (chip_smoke.py's K2 bound)."""
    return nnz * 8 + (n_rows + 1) * 4 + (n_blocks + 1) * 4 + n_cols * 4 \
        + n_rows * 4


def cusparse(row_ptr, cols, vals, shape) -> torch.Tensor:
    """torch's sparse CSR view of CSR arrays (cuSPARSE on the card)."""
    with warnings.catch_warnings():  # beta-state notice of sparse CSR
        warnings.simplefilter("ignore")
        return torch.sparse_csr_tensor(row_ptr.long(), cols.long(), vals,
                                       size=shape)


def device_ms(fn, calls: int = 3) -> float:
    """The profiler's device-busy ms per call of fn (kernel time summed
    over `calls` calls). The first profile of a process starts the
    tracer and is thrown away."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    busy = 0.0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != \
                torch.autograd.DeviceType.CUDA:
            continue
        busy += getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0.0))
    return busy / calls / 1e3


def flushed_ms(fn, flush: torch.Tensor, iters: int) -> float:
    """Median ms of one call of fn with the L2 cache flushed before it."""
    fn()
    times = []
    for _ in range(iters):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_row(extra: dict, name: str, src, *, launches: int, wrapper,
               plain, library, x, bytes_moved: float, flops: float,
               wall_ms: float, iters: int = 20, **fields) -> None:
    """One kernel path's row in extra["kernels"] (on the card only): the
    wrapper against its plain version on x (rtol 1e-5, atol 1e-5 *
    max|y|; raises otherwise), one call flushed, the plain version and
    the one-call library function (None: there is none), the bound, the
    profiler's device-busy ms per call beside the wall ms per call of the
    timed run, and `fields`. `launches` are the wrapper's over the
    section's run, counted before these calls."""
    if x.device.type != "cuda":
        return
    got, want = wrapper(x), plain(x)
    err = (got - want).abs()
    scale = float(want.abs().max())
    if not (bool(torch.isfinite(got).all())
            and bool((err <= 1e-5 * want.abs() + 1e-5 * scale).all())):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max |err| {float(err.max())})")
    flush = torch.ones(64 * 2 ** 20, device=x.device)  # 256 MB > L2
    bound_ms, bound_by = bound(bytes_moved, flops)
    lib_ms = None
    if library is not None:
        lib_err = float((library(x) - want).abs().max())
        if not lib_err <= 1e-4 * max(scale, 1e-30):
            raise AssertionError(f"{name}: library call disagrees "
                                 f"({lib_err})")
        lib_ms = flushed_ms(lambda: library(x), flush, iters)
    row = dict(name=name, route="cuda", source=src[0], replaces=src[1],
               launches=int(launches), max_abs_err=float(err.max()),
               ms=flushed_ms(lambda: wrapper(x), flush, iters),
               plain_ms=flushed_ms(lambda: plain(x), flush, max(2,
                                                                 iters // 4)),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
               device_ms=device_ms(lambda: wrapper(x)), wall_ms=wall_ms,
               **fields)
    extra.setdefault("kernels", []).append(row)
    log(f"  row {name}: {row['ms']:.4f} ms flushed, device "
        f"{row['device_ms']:.4f}, wall {wall_ms:.4f}, bound "
        f"{bound_ms:.4f} ({bound_by}), plain {row['plain_ms']:.4f}, "
        f"library {lib_ms}, launches {launches}")


def bench_cpu_reference(A_scipy, n_iters: int) -> float:
    """Reference execution model: scipy CSR SpMV on the host, float32."""
    A = (A_scipy / 8.0).tocsr().astype(np.float32)
    x = np.ones((A.shape[0],), dtype=np.float32)
    A @ x  # warm up
    t0 = time.perf_counter()
    for _ in range(n_iters):
        x = A @ x
    dt = time.perf_counter() - t0
    return A.nnz * n_iters / dt


def measure_hbm_bw(dev: torch.device) -> tuple:
    """Measured device-memory bandwidths (bytes/s): (bw_rw, bw_read).

    bw_rw:   y = a * x over a 256 MB array, 20 passes (each reads and
             writes the array);
    bw_read: 20 read passes of a dot product over a window of the array
             that moves by one element a pass (a scalar out).
    A reading outside BW_PLAUSIBLE raises: it is a timing fault."""
    nwords = 64 * 1024 * 1024
    x = torch.ones(nwords, device=dev)
    seg_len = nwords - 64

    def run():
        y = x
        for _ in range(20):
            y = y * 1.000001
        return y

    def run_read():
        c = torch.zeros((), device=dev)
        for i in range(20):
            seg = x[i % 64:i % 64 + seg_len]
            c = c + torch.dot(seg, seg) * 1e-30
        return c

    run()
    dt, y = seconds(run, dev)
    finite(y, "hbm probe")
    bw = 2 * 20 * nwords * 4 / max(dt, 1e-12)
    run_read()
    dtr, _ = seconds(run_read, dev)
    bw_read = 20 * seg_len * 4 / max(dtr, 1e-12)
    for name, v in (("rw-mix", bw), ("read", bw_read)):
        if not BW_PLAUSIBLE[0] < v < BW_PLAUSIBLE[1]:
            raise RuntimeError(f"memory probe implausible: {name} "
                               f"{v / 1e9:.0f} GB/s")
    return bw, bw_read


# ----------------------------------------------------------------- sections
def dia_bf16_exact(pmv, pmv16, n: int, dev: torch.device) -> bool:
    """The K1 bf16 gate: bf16 diagonals give bitwise the f32 result on a
    linspace probe."""
    probe = torch.from_numpy(
        np.linspace(-1.0, 1.0, n, dtype=np.float32)).to(dev)
    return bool(torch.equal(pmv16.matvec(probe), pmv.matvec(probe)))


def taps_bf16_exact(dia) -> bool:
    """The K4 bf16 gate (host check): the diagonals survive a round trip
    through bf16."""
    d32 = dia.diags.detach().float().cpu()
    return bool(torch.equal(d32.bfloat16().float(), d32))


def bench_spmv(n_grid: int, n_iters: int, extra: dict, dev: torch.device):
    """Structured-grid SpMV paths; returns (best_edges_per_s, cpu_ref)."""
    from gnnla_tpu_torch.ops.dia import to_dia
    from gnnla_tpu_torch.ops.dia_spmv import dia_kernel_operator
    from gnnla_tpu_torch.ops.stencil_kernel import make_stencil_spmv
    from gnnla_tpu_torch.problems import laplacian_2d

    # drop the kron-artifact explicit zeros: edges/s counts real nonzeros.
    # scale by 1/||A||_inf = 1/8 so the chained iterate stays bounded.
    op_raw = laplacian_2d(n_grid, device=dev).eliminate_zeros()
    op = op_raw.scale(1.0 / 8.0)
    dia = to_dia(op)
    n = op.n_rows
    x0 = torch.ones(n, device=dev)

    if dev.type == "cuda":
        bw, bw_read = measure_hbm_bw(dev)
        extra["hbm_bw_gbs"] = bw / 1e9
        extra["hbm_read_bw_gbs"] = bw_read / 1e9
        log(f"hbm stream bw:   {bw / 1e9:.0f} GB/s rw-mix, "
            f"{bw_read / 1e9:.0f} GB/s read (measured)")
    else:
        extra["hbm_bw_gbs"] = extra["hbm_read_bw_gbs"] = None
        log("hbm stream bw:   not measured (no card)")

    def roofline(eps, read_bytes_per_mv, write_bytes_per_mv):
        """The bytes the work needs (not the layout) at the measured rate
        over the card's peak; None off the card."""
        if dev.type != "cuda":
            return None
        eff = read_bytes_per_mv + write_bytes_per_mv
        return (eps / dia.nnz) * eff / HBM_BYTES_PER_S

    dia_eps = bench_rate(dia.matvec, x0, dia.nnz, n_iters, dev)
    extra["dia_shift_edges_per_s"] = dia_eps
    log(f"dia/shift:       {dia_eps:.3e} edges/s")

    k = len(dia.offsets)
    pmv = dia_kernel_operator(dia)
    pallas_eps = bench_rate(pmv.matvec, x0, pmv.nnz, n_iters, dev)
    frac = roofline(pallas_eps, (k * 4 + 4) * n, 4 * n)
    extra["dia_pallas_edges_per_s"] = pallas_eps
    extra["dia_pallas_roofline_frac"] = frac
    log(f"dia/K1:          {pallas_eps:.3e} edges/s"
        + (f" ({frac:.0%} of HBM roofline)" if frac else ""))
    tiles = pmv.tiles
    lib_a = cusparse(op.row_ptr, op.cols, op.vals, op.shape)
    kernel_row(extra, "dia_spmv[bench]", K1_SRC, launches=pmv.launches,
               wrapper=pmv.matvec, plain=pmv.plain().matvec,
               library=lambda x: lib_a @ x, x=x0,
               bytes_moved=tiles.nbytes + 2 * n * 4,
               flops=2 * tiles.seg_vals.numel(),
               wall_ms=pmv.nnz / pallas_eps * 1e3)

    # bf16 diagonal storage halves the dominant stream; counts toward the
    # headline only when bit-exact on this matrix (the Laplacian's values
    # are bf16-representable, so it is)
    pallas16_eps = 0.0
    pmv16 = dia_kernel_operator(dia, diag_dtype=torch.bfloat16)
    exact = dia_bf16_exact(pmv, pmv16, n, dev)
    log(f"dia/K1-bf16 gate: {'exact' if exact else 'not exact'} on this "
        "matrix")
    if exact:
        pmv16.launches = 0  # the gate's launch is not the path's
        pallas16_eps = bench_rate(pmv16.matvec, x0, pmv16.nnz, n_iters,
                                  dev)
        frac = roofline(pallas16_eps, (k * 2 + 4) * n, 4 * n)
        extra["dia_pallas_bf16_edges_per_s"] = pallas16_eps
        extra["dia_pallas_bf16_roofline_frac"] = frac
        log(f"dia/K1-bf16:     {pallas16_eps:.3e} edges/s (exact"
            + (f", {frac:.0%} of HBM roofline)" if frac else ")"))
        t16 = pmv16.tiles
        kernel_row(extra, "dia_spmv_bf16[bench]", K1_SRC,
                   launches=pmv16.launches, wrapper=pmv16.matvec,
                   plain=pmv16.plain().matvec, library=None, x=x0,
                   bytes_moved=t16.nbytes + 2 * n * 4,
                   flops=2 * t16.seg_vals.numel(),
                   wall_ms=pmv16.nnz / pallas16_eps * 1e3)

    # K4: n_iters steps in one call; bf16 taps count toward the headline
    # only when the storage round trip is bit-exact on this matrix
    bf16_taps = taps_bf16_exact(dia)
    tap_dtype = torch.bfloat16 if bf16_taps else torch.float32
    log(f"stencil bf16 gate: {'exact' if bf16_taps else 'not exact'}; "
        f"taps {str(tap_dtype).replace('torch.', '')}")
    st = make_stencil_spmv(op, (n_grid, n_grid), n_steps=n_iters,
                           tap_dtype=tap_dtype)
    call = st._call
    x2d = x0.reshape(n_grid, n_grid)
    y = st.apply(x2d)  # warm up
    dt, y = seconds(lambda: st.apply(y), dev)
    finite(y, "stencil")
    stencil_eps = st.nnz * n_iters / max(dt, 1e-12)
    extra["stencil_resident_edges_per_s"] = stencil_eps
    log(f"stencil K4 ({str(tap_dtype).replace('torch.', '')}, "
        f"{call.form.form} form, {call.launches} launches): "
        f"{stencil_eps:.3e} edges/s")
    kt = call.taps.shape[0]
    kernel_row(extra, f"stencil[bench,{n_iters} steps]", K4_SRC,
               launches=call.launches, wrapper=st.apply,
               plain=lambda x: call.plain(x), library=None, x=x2d,
               bytes_moved=(kt * call.taps.element_size() + 8) * n,
               flops=n_iters * n * 2 * kt, wall_ms=dt * 1e3, iters=5,
               form=call.form.form)

    # the COO path is scatter-bound: fewer iterations keep its share of
    # the wall time bounded
    coo_eps = bench_rate(op.matvec, x0, op.nnz, max(5, n_iters // 100),
                         dev)
    extra["coo_segment_edges_per_s"] = coo_eps
    log(f"coo/segment-sum: {coo_eps:.3e} edges/s")

    best = max(coo_eps, dia_eps, pallas_eps, pallas16_eps, stencil_eps)
    cpu_edges_s = bench_cpu_reference(op_raw.to_scipy(), n_iters=10)
    extra["cpu_reference_edges_per_s"] = cpu_edges_s
    log(f"cpu reference:   {cpu_edges_s:.3e} edges/s")
    return best, cpu_edges_s


def build_general_fixture(n: int, extra: dict):
    """Host-only build of the unstructured fixture (k-NN graph + RCM)."""
    from gnnla_tpu_torch.ops.stream_spmv import rcm_csr

    t0 = time.perf_counter()
    lap = knn_laplacian(n)
    lap = (lap / (abs(lap).sum(axis=1).max() * 1.01)).tocsr()
    lap.sort_indices()
    A, _ = rcm_csr(lap)
    dt = time.perf_counter() - t0
    extra["general_fixture_build_seconds"] = dt
    log(f"general fixture: k-NN-32 Laplacian n={n} nnz={A.nnz} "
        f"({dt:.1f}s incl. RCM)")
    return A


def bench_general(n: int, extra: dict, dev: torch.device, A=None):
    """Unstructured-graph SpMV through K2, with its error against scipy
    asserted in the same run: the workload class of the reference's one
    hot kernel, torch_scatter.scatter over arbitrary edge lists."""
    from gnnla_tpu_torch.ops.stream_spmv import CsrSpMV

    if A is None:
        A = build_general_fixture(n, extra)

    t0 = time.perf_counter()
    mv = CsrSpMV(A, device=dev)
    build_s = time.perf_counter() - t0
    n_blocks = mv.row_blocks.shape[0] - 1
    extra["general_graph_build_seconds"] = build_s
    extra["general_graph_slot_waste"] = 1.0
    log(f"K2 build:        {build_s:.1f}s row_blocks={n_blocks} "
        f"long_rows={mv.long_rows} slot_waste=1.00x (CSR)")
    extra["general_graph_nnz"] = int(A.nnz)
    extra["general_graph_n"] = int(n)

    rng = np.random.default_rng(0)
    x = rng.standard_normal(n).astype(np.float32)
    xt = torch.from_numpy(x).to(dev)
    y = mv(xt).cpu().numpy()
    expect = A @ x
    relerr = float(np.abs(y - expect).max() / np.abs(expect).max())
    extra["general_graph_relerr"] = relerr
    log(f"on-device rel err: {relerr:.2e}")
    if not relerr < 1e-4:
        raise AssertionError(f"K2 MISMATCH: rel err {relerr}")

    n_it = 100
    mv.launches = 0  # the check's launch is not the timed path's
    eps = bench_rate(mv, torch.ones(n, device=dev), mv.nnz, n_it, dev)
    extra["general_graph_edges_per_s"] = eps
    bytes_total = csr_bytes(A.nnz, n, n, n_blocks)
    bpe = bytes_total / A.nnz
    frac = eps * bpe / HBM_BYTES_PER_S if dev.type == "cuda" else None
    extra["general_graph_bytes_per_edge"] = bpe
    extra["general_graph_roofline_frac"] = frac
    log(f"K2 spmv:         {eps:.3e} edges/s ({bpe:.1f} B/edge"
        + (f" -> {frac:.0%} of HBM roofline)" if frac else ")"))
    lib = cusparse(mv.row_ptr, mv.cols, mv.vals, mv.shape)
    kernel_row(extra, "csr_spmv[bench,knn32]", K2_SRC, launches=mv.launches,
               wrapper=mv, plain=mv.plain, library=lambda x: lib @ x, x=xt,
               bytes_moved=bytes_total,
               flops=2 * mv.nnz, wall_ms=mv.nnz / eps * 1e3,
               row_blocks=n_blocks)

    # reference execution model on the same matrix
    xx = x.copy()
    A @ xx
    t0 = time.perf_counter()
    for _ in range(20):
        xx = A @ xx
    cpu = A.nnz * 20 / (time.perf_counter() - t0)
    extra["general_graph_cpu_edges_per_s"] = cpu
    extra["general_graph_vs_cpu"] = eps / cpu
    log(f"cpu scipy:       {cpu:.3e} edges/s (K2 = {eps / cpu:.0f}x)")
    return A, mv, eps


def bench_spmm(A, mv, eps, extra: dict, dev: torch.device):
    """Multi-RHS SpMM through K3: one pass over the CSR computes all M
    columns — the spectral loss's T @ Y workload."""
    n = A.shape[0]
    rng = np.random.default_rng(0)
    M = int(os.environ.get("GNNLA_SPMM_RHS", "8"))
    Xs = rng.standard_normal((n, M)).astype(np.float32)
    X = torch.from_numpy(Xs).to(dev)
    Ym = mv(X).cpu().numpy()
    em = A @ Xs
    relerr_m = float(np.abs(Ym - em).max() / np.abs(em).max())
    extra["general_graph_spmm_relerr"] = relerr_m
    if not relerr_m < 1e-4:
        raise AssertionError(f"spmm MISMATCH: rel err {relerr_m}")
    n_it2 = 50
    mv.launches_mm = 0
    ecs = bench_rate(mv, X, A.nnz * M, n_it2, dev)
    extra["general_graph_spmm_edge_cols_per_s"] = ecs
    extra["general_graph_spmm_n_rhs"] = M
    log(f"K3 spmm M={M}:    {ecs:.3e} edge-cols/s "
        f"({ecs / M / max(eps, 1e-30):.2f}x per column vs spmv)")
    lib = cusparse(mv.row_ptr, mv.cols, mv.vals, mv.shape)
    kernel_row(extra, f"csr_spmm[bench,M={M}]", K3_SRC,
               launches=mv.launches_mm, wrapper=mv, plain=mv.plain,
               library=lambda x: torch.sparse.mm(lib, x), x=X,
               bytes_moved=mv.nnz * 8 + (n + 1) * 4 + 2 * n * M * 4,
               flops=2 * mv.nnz * M, wall_ms=A.nnz * M / ecs * 1e3)


def bench_bsr(A, eps, extra: dict, dev: torch.device):
    """BSR (dense 128^2 blocks) — the other general-graph layout, recorded
    so its keep-or-fold decision rests on numbers. Its per-edge traffic is
    the dense blocks' padding times K2's, so the fixture is capped at
    BSR_N_CAP points of the same family."""
    from gnnla_tpu_torch.ops.bsr import to_bsr
    from gnnla_tpu_torch.ops.sparse import SparseOperator
    from gnnla_tpu_torch.ops.stream_spmv import rcm_csr

    rng = np.random.default_rng(0)
    n = A.shape[0]
    if n > BSR_N_CAP:
        Ab, _ = rcm_csr(knn_laplacian(BSR_N_CAP))
        Ab = (Ab / (abs(Ab).sum(axis=1).max() * 1.01)).tocsr()
        Ab.sort_indices()
        log(f"bsr fixture capped at n={BSR_N_CAP} (same family)")
    else:
        Ab = A
    nb_rows = Ab.shape[0]
    t0 = time.perf_counter()
    bsr = to_bsr(SparseOperator.from_scipy(Ab, device=dev), block_size=128)
    nb = bsr.blocks.shape[0]
    waste = nb * 128 * 128 / Ab.nnz
    log(f"bsr build:       {time.perf_counter() - t0:.1f}s "
        f"nb={nb} slot_waste={waste:.1f}x")
    xb = rng.standard_normal(nb_rows).astype(np.float32)
    yb = bsr.matvec(torch.from_numpy(xb).to(dev)).cpu().numpy()
    eb = Ab @ xb
    relerr_b = float(np.abs(yb - eb).max() / np.abs(eb).max())
    extra["general_graph_bsr_relerr"] = relerr_b
    if not relerr_b < 1e-4:
        raise AssertionError(f"bsr MISMATCH: rel err {relerr_b}")
    eps_b = bench_rate(bsr.matvec, torch.ones(nb_rows, device=dev), Ab.nnz,
                       50, dev)
    extra["general_graph_bsr_edges_per_s"] = eps_b
    extra["general_graph_bsr_n"] = int(nb_rows)
    extra["general_graph_bsr_slot_waste"] = waste
    log(f"bsr spmv:        {eps_b:.3e} edges/s "
        f"(K2 = {eps / max(eps_b, 1e-30):.1f}x faster)")


def build_agg_fixture(n: int = AGG_N, k: int = 32):
    """Host-only build of the unstructured aggregation fixture (k-NN
    edges + EllLayout pack plan)."""
    from gnnla_tpu_torch.ops.band import EllLayout

    t0 = time.perf_counter()
    lap = knn_laplacian(n, k=k).tocoo()
    off = lap.row != lap.col
    rows = np.ascontiguousarray(lap.row[off])
    cols = np.ascontiguousarray(lap.col[off])
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    lay = EllLayout(rows, cols, n)
    log(f"agg fixture:     k-NN-{k} n={n} E={rows.size} K={lay.k} "
        f"(slot fill {rows.size / (lay.k * n):.2f}, "
        f"{time.perf_counter() - t0:.1f}s)")
    return n, rows, cols, lay


def agg_inputs(fixture, dev: torch.device):
    """(slots [K, N], deg [N], edge values [E], rows [E]) on `dev`: the
    fixture's seeded edge values in ELL slot and edge order."""
    n, rows, cols, lay = fixture
    v_h = np.random.default_rng(1).standard_normal(rows.size).astype(
        np.float32)
    return (torch.from_numpy(lay.pack(v_h)).to(dev),
            torch.from_numpy(lay.deg).to(dev), torch.from_numpy(v_h).to(dev),
            torch.from_numpy(rows.astype(np.int64)).to(dev))


def bench_agg_unstructured(extra: dict, dev: torch.device, fixture=None):
    """4-way (min, mean, sum, max) edge->vertex aggregation on an
    unstructured k-NN graph — the torch_scatter workload of the learned
    models on meshfree patterns. Paths:
      ell      zero-gather EllLayout slot reduce (ops/band.py)
      segment  scatter-based multi_segment_reduce (ops/segment.py)
      cpu      torch.scatter_reduce on the host (the reference's model)
    Parity between ell and segment asserted in the same run."""
    from gnnla_tpu_torch.ops.band import ell_multi_reduce
    from gnnla_tpu_torch.ops.segment import multi_segment_reduce

    if fixture is None:
        fixture = build_agg_fixture()
    n, rows, cols, lay = fixture
    E = rows.size
    extra["agg4_unstructured_n"] = int(n)
    extra["agg4_unstructured_edges"] = int(E)
    extra["agg4_unstructured_k_slots"] = int(lay.k)
    slots0, deg, v0, rows_t = agg_inputs(fixture, dev)

    out_ell = ell_multi_reduce(AGGS, slots0, deg)
    out_seg = multi_segment_reduce(AGGS, v0[:, None], rows_t, n)
    perr = float((out_ell - out_seg).abs().max()
                 / max(float(out_seg.abs().max()), 1e-30))
    extra["agg4_unstructured_rel_err"] = perr
    if not perr < 1e-5:
        raise AssertionError(f"ELL vs segment MISMATCH: rel err {perr}")

    def agg_ell(slots):
        out = ell_multi_reduce(AGGS, slots, deg)           # [N, 4]
        return slots * 0.999 + 1e-6 * out.sum(dim=1)[None, :]

    ell_eps = bench_rate(agg_ell, slots0, E, 100, dev)
    extra["agg4_ell_edges_per_s"] = ell_eps
    log(f"4-way agg ell:   {ell_eps:.3e} edges/s (zero-gather)")

    def agg_seg(v):
        out = multi_segment_reduce(AGGS, v[:, None], rows_t, n)
        return v * 0.999 + 1e-6 * out.sum(dim=1)[rows_t]

    seg_eps = bench_rate(agg_seg, v0, E, 5, dev)
    extra["agg4_unstructured_segment_edges_per_s"] = seg_eps
    log(f"4-way agg seg:   {seg_eps:.3e} edges/s (scatter path)")

    # host baseline: torch scatter_reduce, all four reducers per pass
    tv = v0.cpu()
    tr = rows_t.cpu()
    outs = {r: torch.zeros(n) for r in ("sum", "mean", "amin", "amax")}

    def cpu_pass():
        for r, o in outs.items():
            o.zero_().scatter_reduce_(0, tr, tv, reduce=r,
                                      include_self=False)

    cpu_pass()
    n_it = 5
    t0 = time.perf_counter()
    for _ in range(n_it):
        cpu_pass()
    cpu_eps = E * n_it / (time.perf_counter() - t0)
    extra["agg4_unstructured_cpu_edges_per_s"] = cpu_eps
    extra["agg4_ell_vs_cpu"] = ell_eps / cpu_eps
    log(f"4-way agg cpu:   {cpu_eps:.3e} edges/s (torch scatter_reduce; "
        f"ell = {ell_eps / cpu_eps:.0f}x)")


def time_cycles(run, b, x0, n_cycles: int, dev: torch.device) -> float:
    """Seconds per cycle: run(b, x) does n_cycles cycles; one warm-up run,
    then two chained runs timed."""
    x = run(b, x0)
    dt, x = seconds(lambda: run(b, run(b, x)), dev)
    finite(x, "cycle")
    return dt / (n_cycles * 2)


def pcg_iters(hist: torch.Tensor, b: torch.Tensor):
    """Iterations until the residual norm falls below 1e-8 ||b|| (None:
    not within the history)."""
    rel = (hist / torch.linalg.vector_norm(b)).cpu().numpy()
    conv = np.flatnonzero(rel < 1e-8)
    return int(conv[0]) + 1 if conv.size else None


def bench_solvers(n_grid: int, extra: dict, dev: torch.device):
    """Composed end-to-end solver timings on the n_grid^2 FD Laplacian."""
    from gnnla_tpu_torch.models import (make_geometric_vcycle,
                                        make_stencil_vcycle, mg_pcg,
                                        setup_sa_multigrid, setup_twogrid,
                                        setup_with_dia,
                                        setup_with_dia_multigrid,
                                        setup_with_stream_p, solve)
    from gnnla_tpu_torch.ops.dia_spmv import DiaKernelOperator
    from gnnla_tpu_torch.problems import laplacian_2d

    n = n_grid * n_grid
    A = laplacian_2d(n_grid, device=dev).eliminate_zeros()
    log(f"solver fixture:  {n_grid}x{n_grid} FD Laplacian ({n} rows)")

    t0 = time.perf_counter()
    setup = setup_twogrid(A, theta=0.25, splitting="cljp", seed=0)
    dt = time.perf_counter() - t0
    extra["amg_setup_seconds"] = dt
    extra["amg_setup_rows"] = n
    log(f"amg setup (cljp, {n} rows): {dt:.1f}s "
        f"(coarse {setup.Ac.n_rows} rows)")

    b = torch.from_numpy(np.random.default_rng(3).standard_normal(n)
                         .astype(np.float32)).to(dev)
    x0 = torch.zeros(n, device=dev)
    n_cyc = 5

    def cycles(s):
        return lambda bb, xx: solve(s, bb, xx, n_cycles=n_cyc)

    t = time_cycles(cycles(setup), b, x0, n_cyc, dev)
    extra["vcycle_coo_ms"] = t * 1e3
    log(f"vcycle (COO):    {t * 1e3:.2f} ms/cycle")

    t = time_cycles(cycles(setup_with_dia(setup)), b, x0, n_cyc, dev)
    extra["vcycle_dia_ms"] = t * 1e3
    log(f"vcycle (DIA):    {t * 1e3:.2f} ms/cycle")

    # the fast setup: both levels on K1, P and P^T on K2
    setup_f = setup_with_stream_p(setup_with_dia(setup, kernel=True))
    t = time_cycles(cycles(setup_f), b, x0, n_cyc, dev)
    extra["vcycle_dia_pallas_stream_ms"] = t * 1e3
    launches = {"K1": setup_f.A.launches + setup_f.Ac.launches,
                "K2": getattr(setup_f.P, "fwd", setup_f.P).launches
                + getattr(setup_f.P, "bwd", setup_f.P).launches}
    log(f"vcycle (K1 + K2 P): {t * 1e3:.2f} ms/cycle (launches {launches})")

    sv = make_stencil_vcycle(setup, (n_grid, n_grid))
    t = time_cycles(lambda bb, xx: chain(lambda x: sv.run(bb, x), xx, n_cyc),
                    b, x0, n_cyc, dev)
    extra["vcycle_stencil_ms"] = t * 1e3
    log(f"StencilVCycle:   {t * 1e3:.2f} ms/cycle (K4 launches "
        f"{sum(c.launches for c in sv.kernel_calls())})")

    gv = make_geometric_vcycle(A, (n_grid, n_grid))
    t = time_cycles(lambda bb, xx: chain(lambda x: gv.run(bb, x), xx, n_cyc),
                    b, x0, n_cyc, dev)
    extra["vcycle_geometric_ms"] = t * 1e3
    log(f"GeometricVCycle: {t * 1e3:.2f} ms/cycle (K4 launches "
        f"{sum(c.launches for c in gv.kernel_calls())})")

    # smoothed-aggregation multilevel PCG to 1e-8 relative (recurrence)
    # residual, every banded level on K1 (flip_sign: the FD Laplacian is
    # negative definite)
    n_it = 30
    t0 = time.perf_counter()
    setup_m = setup_with_dia_multigrid(setup_sa_multigrid(A, seed=0),
                                       kernel=True)
    n_dia = sum(isinstance(a, DiaKernelOperator) for a in setup_m.As)
    log(f"SA multigrid setup: {time.perf_counter() - t0:.1f}s "
        f"({setup_m.n_levels} levels, {n_dia} on K1)")

    def run_pcg():
        return mg_pcg(setup_m, b, torch.zeros_like(b), n_iters=n_it,
                      flip_sign=True)

    _, hist = run_pcg()
    dt, (x, _) = seconds(run_pcg, dev)
    finite(x, "mg_pcg")
    iters = pcg_iters(hist, b)
    extra["pcg_ms_per_iter"] = dt / n_it * 1e3
    extra["pcg_iters_to_1e8"] = iters
    if iters:
        extra["pcg_seconds_to_1e8"] = dt / n_it * iters
        log(f"SA mg_pcg:       {dt / n_it * 1e3:.2f} ms/iter, {iters} iters "
            f"to 1e-8 ({dt / n_it * iters * 1e3:.1f} ms)")
    else:
        extra["pcg_seconds_to_1e8"] = None
        log(f"SA mg_pcg:       {dt / n_it * 1e3:.2f} ms/iter, no 1e-8 "
            f"within {n_it} iters")


def bench_train(extra: dict, dev: torch.device):
    """Steady-state trainable-Jacobi train step (batch 32, 38x38 FEM) on
    both gather-free loss layouts: DIA diagonals and grid stencil planes.
    Each layout starts from the same MLP (generator seed 0) and a fresh
    Adam; after the same 21 steps their losses agree within 1e-3."""
    from gnnla_tpu_torch.models.trainable_jacobi import TrainableJacobiMLP
    from gnnla_tpu_torch.training.datasets import small_band_dataset
    from gnnla_tpu_torch.training.train_jacobi import (_draw_probes,
                                                       feature_stack,
                                                       make_loss_fn,
                                                       matrix_stack)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    t0 = time.perf_counter()
    ds = small_band_dataset(32, n=38, seed=1, cache_dir=None, device=dev)
    probes = _draw_probes(ds, range(ds.n_graphs), 20,
                          np.random.default_rng(0))
    base_args = (f32(feature_stack(ds)), f32(ds.diags), f32(probes))
    log(f"train fixture:   32 small-band matrices "
        f"({time.perf_counter() - t0:.1f}s)")

    losses = {}
    for layout in ("dia", "stencil"):
        model = TrainableJacobiMLP(widths=(50, 20, 1), generator=0,
                                   device=dev)
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        loss_fn = make_loss_fn(model, ds, 2.0 / 3.0, 3, layout=layout)
        mats = f32(matrix_stack(ds, layout))

        def step():
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(mats, *base_args)
            loss.backward()
            opt.step()
            return loss.detach()

        step()
        n_steps = 20
        dt, loss = seconds(lambda: chain(lambda _: step(), None, n_steps),
                           dev)
        fl = float(loss)
        if not np.isfinite(fl):
            raise AssertionError(f"train/{layout}: loss {fl}")
        losses[layout] = fl
        extra[f"train_step_{layout}_ms"] = dt / n_steps * 1e3
        log(f"train step/{layout:7s}: {dt / n_steps * 1e3:.2f} ms "
            f"(batch 32, loss {fl:.4f})")
    if not abs(losses["dia"] - losses["stencil"]) <= \
            1e-3 * max(abs(losses["dia"]), 1e-9):
        raise AssertionError(f"train: layouts disagree {losses}")
    extra["train_step_ms"] = min(extra["train_step_dia_ms"],
                                 extra["train_step_stencil_ms"])


def convergence_factors(s: int, dev: torch.device, k: int = 8) -> tuple:
    """(classical two-grid, SA multilevel) convergence factors
    (||r_k|| / ||r_0||)^(1/k) after k cycles from zero on the unscaled
    s^2 FD Laplacian with b = 1: the CLJP two-grid `solve` and the SA
    V-cycle (n_pre = n_post = 2) on K1 levels."""
    from gnnla_tpu_torch.models import (multigrid_cycle, residual,
                                        setup_sa_multigrid, setup_twogrid,
                                        setup_with_dia_multigrid, solve)
    from gnnla_tpu_torch.problems import laplacian_2d

    # UNSCALED operator: the reference cycle's Chebyshev coarse interval
    # (c=-3.4, d=-4.0) is calibrated to the -4-diagonal FD Laplacian
    op = laplacian_2d(s, device=dev).eliminate_zeros()
    b = torch.ones(op.n_rows, device=dev)
    r0 = float(torch.linalg.vector_norm(b))

    tg = setup_twogrid(op, splitting="cljp", seed=0)
    xk = solve(tg, b, torch.zeros_like(b), n_cycles=k)
    cf_cl = (float(torch.linalg.vector_norm(residual(op, b, xk))) / r0) \
        ** (1 / k)

    sa = setup_with_dia_multigrid(setup_sa_multigrid(op, seed=0),
                                  kernel=True)
    xs = torch.zeros_like(b)
    for _ in range(k):
        xs = multigrid_cycle(sa, b, xs, n_pre=2, n_post=2)
    cf_sa = (float(torch.linalg.vector_norm(residual(op, b, xs))) / r0) \
        ** (1 / k)
    return cf_cl, cf_sa


def bench_convergence(n_grid: int, extra: dict, dev: torch.device):
    """Per-cycle convergence factor vs problem size: classical two-grid
    (the reference's pipeline) against SA multilevel, whose factor stays
    flat as the size grows."""
    sizes = [s for s in (64, 128, 256, 512) if s <= max(64, n_grid // 2)]
    table = {}
    for s in sizes:
        cf_cl, cf_sa = convergence_factors(s, dev)
        table[s] = (cf_cl, cf_sa)
        extra[f"convfac_classical_{s}"] = cf_cl
        extra[f"convfac_sa_{s}"] = cf_sa
        log(f"conv factor {s:4d}^2: classical two-grid {cf_cl:.3f}   "
            f"SA multilevel {cf_sa:.3f}")
    if len(sizes) >= 2:
        s0, s1 = sizes[0], sizes[-1]
        extra["convfac_sa_flat"] = table[s1][1] - table[s0][1]
        log(f"SA factor drift {s0}^2 -> {s1}^2: "
            f"{extra['convfac_sa_flat']:+.3f} (flat = scalable)")


def bench_diffusion(extra: dict, dev: torch.device, n_agg: int = 1024):
    """Learned-GN-block paths:

    1. the 4-way (min, mean, sum, max) edge->vertex aggregation — the hot
       op of every learned model — on the dense row layout, the scatter
       segment path and the zero-gather band layout, on the n_agg^2 grid
       pattern;
    2. a full diffusion train step at reference scale (n_mesh = 80, batch
       16, the best combination: 1 ext / 2 int / 32 hidden, encoder
       (3, 16)) on the band layout, and its edge-order twin."""
    from gnnla_tpu_torch.models.diffusion_gnn import DiffusionGNN
    from gnnla_tpu_torch.ops.band import BandLayout, band_multi_reduce
    from gnnla_tpu_torch.ops.segment import (DenseRowLayout,
                                             multi_segment_reduce)
    from gnnla_tpu_torch.problems import laplacian_2d
    from gnnla_tpu_torch.training.datasets import cosine_diffusion_dataset
    from gnnla_tpu_torch.training.train_diffusion import (edge_features,
                                                          loss_terms,
                                                          make_apply,
                                                          make_apply_banded)

    op = laplacian_2d(n_agg, device=dev).eliminate_zeros().remove_diagonal()
    rows_h, _, _ = op.host_coo()
    lay = DenseRowLayout(rows_h, op.n_rows)
    E = op.nnz
    v_h = np.random.default_rng(0).standard_normal(E).astype(np.float32)
    v0 = torch.from_numpy(v_h).to(dev)

    gi = torch.from_numpy(lay.gather_idx).to(dev)
    mask = torch.from_numpy(lay.mask).to(dev)
    deg = torch.from_numpy(np.maximum(lay.deg, 1).astype(np.float32)).to(dev)
    rows_t = op.rows.long()

    def agg_dense(v):
        p = v[gi]
        s = torch.where(mask, p, 0.0).sum(dim=1)
        mx = torch.where(mask, p, float("-inf")).amax(dim=1)
        mn = torch.where(mask, p, float("inf")).amin(dim=1)
        out = torch.stack([torch.where(torch.isposinf(mn), 0.0, mn),
                           s / deg, s,
                           torch.where(torch.isneginf(mx), 0.0, mx)], dim=1)
        # fold back to edge space so the bench can chain output->input
        return v * 0.999 + 1e-6 * out.sum(dim=1)[rows_t]

    def agg_seg(v):
        out = multi_segment_reduce(AGGS, v[:, None], rows_t, op.n_rows)
        return v * 0.999 + 1e-6 * out.sum(dim=1)[rows_t]

    dense_eps = bench_rate(agg_dense, v0, E, 50, dev)
    extra["agg4_dense_edges_per_s"] = dense_eps
    seg_eps = bench_rate(agg_seg, v0, E, 5, dev)
    extra["agg4_segment_edges_per_s"] = seg_eps
    extra["agg4_speedup"] = dense_eps / seg_eps
    log(f"4-way agg dense: {dense_eps:.3e} edges/s "
        f"({dense_eps / seg_eps:.1f}x the segment path {seg_eps:.2e})")

    # band layout — the production path of the learned models: edge
    # values live in [K, N] band order end to end, so the 4-way reduction
    # is a masked axis reduction with no gather
    blay = BandLayout(op)
    bands0 = torch.from_numpy(blay.pack(v_h)).to(dev)
    bmask = torch.from_numpy(blay.mask).to(dev)
    bdeg = torch.from_numpy(np.maximum(blay.deg, 1).astype(np.float32)).to(
        dev)

    def agg_band(bands):
        out = band_multi_reduce(AGGS, bands, bmask, bdeg)   # [N, 4]
        return bands * 0.999 + 1e-6 * out.sum(dim=1)[None, :]

    band_eps = bench_rate(agg_band, bands0, E, 200, dev)
    extra["agg4_band_edges_per_s"] = band_eps
    extra["agg4_band_speedup"] = band_eps / seg_eps
    log(f"4-way agg band:  {band_eps:.3e} edges/s "
        f"({band_eps / seg_eps:.0f}x the segment path; zero-gather)")

    # ---- full diffusion train step ------------------------------------
    # reference scale on the card; small twin for small smoke runs
    B, n_mesh = (16, 80) if n_agg >= 512 else (4, 16)
    t0 = time.perf_counter()
    ds = cosine_diffusion_dataset(B, n=n_mesh, max_freq=3.0, seed=3,
                                  cache_dir=None, device=dev)
    log(f"diffusion fixture: {B} matrices n={n_mesh} "
        f"({time.perf_counter() - t0:.1f}s)")
    rel = edge_features(ds, n_mesh)
    model = DiffusionGNN(n_layers_external=1, n_layers_internal=2,
                         n_hidden=32, encoder=(3, 16), generator=0,
                         device=dev)
    apply_b, band_pack = make_apply_banded(model, ds, rel,
                                           grid_shape=(n_mesh, n_mesh))
    apply_edge = make_apply(model, ds, rel)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    rest = (f32(ds.diags), f32(ds.globals_), f32(ds.targets))
    n_steps = 10

    def step_ms(apply, ov):
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)

        def step():
            opt.zero_grad(set_to_none=True)
            loss = loss_terms(apply(ov, *rest[:2]), rest[2])
            loss.backward()
            opt.step()
            return loss.detach()

        step()
        dt, loss = seconds(lambda: chain(lambda _: step(), None, n_steps),
                           dev)
        fl = float(loss)
        if not np.isfinite(fl):
            raise AssertionError(f"diffusion step: loss {fl}")
        return dt / n_steps * 1e3, fl

    ms, fl = step_ms(apply_b, f32(band_pack(ds.offdiag_vals)))
    extra["diffusion_step_ms"] = ms
    extra["diffusion_edges_per_s"] = B * ds.template_nodiag.nnz / (ms / 1e3)
    log(f"diffusion step:  {ms:.1f} ms (batch {B}, n={n_mesh}, loss "
        f"{fl:.4f}, {extra['diffusion_edges_per_s']:.2e} edge-visits/s; "
        "band layout)")

    # edge-order twin of the same step, for the layout speedup record
    ms_e, _ = step_ms(apply_edge, f32(ds.offdiag_vals))
    extra["diffusion_step_edge_ms"] = ms_e
    extra["diffusion_band_speedup"] = ms_e / ms
    log(f"diffusion step (edge-order twin): {ms_e:.1f} ms "
        f"(band layout = {ms_e / ms:.1f}x faster)")


def bench_sharded(extra: dict, dev: torch.device):
    """The sharded families (K2 per shard with a forced halo tile and its
    VJP, the sharded stream V-cycle, the sharded stencil matvec) on a
    world of one rank on the device, their parity asserted inside
    `run_sharded_hardware_check`."""
    from gnnla_tpu_torch.parallel.distributed import launched_ranks
    from gnnla_tpu_torch.parallel.hardware_check import \
        run_sharded_hardware_check

    with launched_ranks(dev.type) as d:
        out = run_sharded_hardware_check(device=d.type)
    extra["sharded_mosaic_ok"] = 1
    extra["sharded_stream_edges_per_s"] = out["stream_spmv_edges_per_s"]
    extra["sharded_stream_spmv_rel_err"] = out["stream_spmv_rel_err"]
    extra["sharded_stream_vjp_x_rel_err"] = out["stream_vjp_x_rel_err"]
    extra["sharded_vcycle_rel_err"] = out["stream_vcycle_rel_err"]
    extra["sharded_stencil_rel_err"] = out["stencil_rel_err"]
    log(f"sharded:         ok on {out['device']} ({out['backend']}, "
        f"ndev={out['ndev']}) — K2 shard {out['stream_spmv_edges_per_s']:.2e}"
        f" edges/s (small fixture, launch-bound), vjp err "
        f"{out['stream_vjp_x_rel_err']:.1e}, vcycle err "
        f"{out['stream_vcycle_rel_err']:.1e}")


# --------------------------------------------------------------------- main
def parse(argv):
    import argparse

    p = argparse.ArgumentParser(prog="python -m gnnla_tpu_torch.bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("n_grid", nargs="?", type=int, default=2048)
    p.add_argument("n_iters", nargs="?", type=int, default=1000)
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch versions on the host")
    return p.parse_args(argv)


def main(argv=None) -> int:
    """Run the sections; returns the exit code (0: every section asked
    for ran or was skipped by the budget; 1: the health probe or a
    section failed)."""
    from gnnla_tpu_torch._device import resolve_device
    from gnnla_tpu_torch.utils.health import health_probe

    args = parse(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    n_grid, n_iters = args.n_grid, args.n_iters
    sections = os.environ.get("GNNLA_BENCH_SECTIONS",
                              DEFAULT_SECTIONS).split(",")
    budget = float(os.environ.get("GNNLA_BENCH_BUDGET_S", "3000"))
    t_start = time.time()
    run = Run()
    extra = run.extra
    extra["device"] = where(dev)

    def on_term(signum, frame):
        log(f"signal {signum}: emitting partial results and exiting")
        run.emit()
        sys.exit(1)

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)

    try:
        probe_s = health_probe(dev)
    except Exception as e:  # the run's boundary: report, emit, stop
        log(f"health probe (K5) FAILED on {where(dev)}: "
            f"{type(e).__name__}: {e}")
        run.emit()
        return 1
    log(f"health probe (K5): ok on {where(dev)} ({probe_s:.2f}s incl. "
        "build)")

    t0 = time.perf_counter()
    prebuilt_A = prebuilt_agg = None
    n_general = min(1 << 20, max(1 << 14, n_grid * n_grid // 4))
    if {"general", "spmm", "bsr"} & set(sections):
        prebuilt_A = build_general_fixture(n_general, extra)
    if "agg" in sections:
        prebuilt_agg = build_agg_fixture(AGG_N)
    extra["warmup_seconds"] = time.perf_counter() - t0
    log(f"fixture prebuild: {extra['warmup_seconds']:.1f}s")

    general_out = {}

    def run_section(name, fn):
        if name not in sections:
            return
        rem = budget - (time.time() - t_start)
        if rem < SECTION_EST.get(name, 120):
            log(f"[{name}] SKIPPED: {rem:.0f}s left < "
                f"{SECTION_EST.get(name, 120)}s estimate")
            extra.setdefault("skipped_sections", []).append(name)
            run.emit()
            return
        t0 = time.perf_counter()
        try:
            fn()
            run.done.append(name)
            log(f"[{name}] done in {time.perf_counter() - t0:.1f}s")
        except Exception as e:  # recorded, the run goes on, exit 1
            log(f"[{name}] FAILED: {type(e).__name__}: {e}\n"
                + traceback.format_exc())
            extra.setdefault("failed_sections", []).append(name)
            if name == "sharded":
                extra["sharded_mosaic_ok"] = 0
        run.emit()

    def spmv():
        run.best, run.cpu = bench_spmv(n_grid, n_iters, extra, dev)

    def general():
        A, mv, eps = bench_general(n_general, extra, dev, A=prebuilt_A)
        general_out.update(A=A, mv=mv, eps=eps)

    run_section("spmv", spmv)
    run_section("general", general)
    run_section("agg", lambda: bench_agg_unstructured(
        extra, dev, fixture=prebuilt_agg))
    run_section("diffusion", lambda: bench_diffusion(
        extra, dev, n_agg=min(1024, n_grid)))
    run_section("train", lambda: bench_train(extra, dev))
    run_section("sharded", lambda: bench_sharded(extra, dev))
    run_section("solvers", lambda: bench_solvers(max(64, n_grid // 2),
                                                 extra, dev))
    run_section("convergence", lambda: bench_convergence(n_grid, extra, dev))
    if general_out:
        run_section("spmm", lambda: bench_spmm(
            general_out["A"], general_out["mv"], general_out["eps"], extra,
            dev))
        run_section("bsr", lambda: bench_bsr(
            general_out["A"], general_out["eps"], extra, dev))
    else:
        for name in ("spmm", "bsr"):
            if name in sections:
                log(f"[{name}] FAILED: needs the general section")
                extra.setdefault("failed_sections", []).append(name)

    run.emit()
    return 1 if extra.get("failed_sections") else 0


if __name__ == "__main__":
    sys.exit(main())
