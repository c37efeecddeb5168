"""Time the PyTorch port's solvers and kernels K1-K4 on one NVIDIA card,
with their spread and device busy time, so two commits can be compared.

    python3 scripts/torch_solver_times.py [--tree DIR] [--windows 9]

On the 1024^2 FD Laplacian, as chip_smoke.py builds them:
  fast     the CLJP two-grid setup (theta 0.25, seed 0) with
           `setup_with_dia(kernel=True)` and `setup_with_stream_p`: ms per
           `solve` cycle (`--windows` CUDA-event windows of 20 cycles),
           device busy ms per cycle (profiler), and the peak device memory
           of the process after the setup and the cycles;
  amg_pcg  `amg_pcg(n_iters=10, flip_sign=True)` on that setup: ms per
           iteration (`--windows` solves);
  mg_pcg   `setup_sa_multigrid(seed=0)` with `setup_with_dia_multigrid(
           kernel=True)`, `mg_pcg(n_iters=30, flip_sign=True)`: ms per
           iteration (`--windows` solves) and device busy ms per iteration;
  gelfand  the vertices shuffled by default_rng(0), the RCM-ordered CSR
           pair negated, one value-and-grad of the SpMM Gelfand loss in
           the diagonal (M = 20 probes, k = 3: 3 + 2 K3 launches): ms per
           value-and-grad (`--windows` windows of 5);
  geometric, stencil, stream
           `GeometricVCycle` on the alternating setup, `AutoTwoGrid` on the
           CLJP setup (its "stencil" leg) and on the shuffled Laplacian
           (its "stream" leg, K2 on the RCM-ordered A): ms per cycle
           (`--windows` windows of 20) and device busy ms per cycle;
  kernels  per K1, K2 and K4 call of those paths, the mean ms of one call
           through its wrapper with the L2 cache flushed before it (a 1 GB
           read, long enough to cover the wrapper's host time), over
           `--windows` x 5 calls: K1 on A and Ac (finite x), K2 on P, P^T,
           A_rcm and A_rcm^T, K4's Ac apply, 3-step Jacobi, residual,
           bf16-tap Jacobi and 3-step plain call on A^T's taps.
b = default_rng(3) normal. Prints one JSON line: the tree, the card and
its power limit, and per metric the median, minimum, maximum and every
window.

`--tree DIR` imports gnnla_tpu_torch from another checkout, e.g. an
earlier commit unpacked with `git archive`; run each tree in its own
process, in the order parent, change, change, parent, within one call.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--windows", type=int, default=9)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gnnla_tpu_torch.models.geometric import GeometricVCycle
    from gnnla_tpu_torch.models.krylov import amg_pcg, mg_pcg
    from gnnla_tpu_torch.models.multigrid import (setup_sa_multigrid,
                                                  setup_with_dia_multigrid)
    from gnnla_tpu_torch.models.vcycle import (AutoTwoGrid, setup_twogrid,
                                               setup_with_dia,
                                               setup_with_stream_p, solve)
    from gnnla_tpu_torch.ops.sparse import SparseOperator
    from gnnla_tpu_torch.ops.stencil import stencil_transpose
    from gnnla_tpu_torch.ops.stencil_kernel import (StencilCall,
                                                    make_stencil_jacobi,
                                                    make_stencil_spmv)
    from gnnla_tpu_torch.ops.stream_op import csr_pair
    from gnnla_tpu_torch.ops.stream_spmv import rcm_csr
    from gnnla_tpu_torch.problems import laplacian_2d
    from gnnla_tpu_torch.training.spectral_loss import (
        damping_factor_gelfand_spmm, uniform_probes)

    if not torch.cuda.is_available():
        print("torch_solver_times: needs an NVIDIA card", file=sys.stderr)
        return 2
    gc.disable()  # no collection pause inside a timed window
    dev = torch.device("cuda")

    def window(fn, reps: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def busy_ms(fn) -> float:
        """Device time of one call of fn: the profiler's CUDA self time
        over 3 calls, after a first profile that starts the tracer."""
        for calls in (1, 3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
        total = sum(
            getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
            for ev in prof.key_averages()
            if getattr(ev, "device_type", None)
            == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False))
        return total / 3e3

    def stats(v):
        return dict(median=float(np.median(v)), min=min(v), max=max(v),
                    windows=v)

    flush = torch.ones(256 * 2 ** 20, device=dev)  # 1 GB, 20x the L2

    def cold_ms(fn, calls: int = 5) -> float:
        """Mean ms of one call of fn, the L2 flushed before each; the
        flush is enqueued first, so the host enqueues the call while the
        device still reads it."""
        fn()
        total = 0.0
        for _ in range(calls):
            flush.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / calls

    def kernel_row(fn):
        return stats([cold_ms(fn) for _ in range(args.windows)])

    def rand(shape, seed):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(
            shape).astype(np.float32)).to(dev)

    A = laplacian_2d(1024, device=dev).eliminate_zeros()
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(
        A.n_rows).astype(np.float32)).to(dev)
    x0 = torch.zeros_like(b)
    out = {}

    fast = setup_with_stream_p(setup_with_dia(
        setup_twogrid(A, theta=0.25, splitting="cljp", seed=0),
        kernel=True))
    torch.cuda.reset_peak_memory_stats()

    def cycle():
        solve(fast, b, x0, n_cycles=1)
    window(cycle, 3)
    out["fast_ms_per_cycle"] = stats([window(cycle, 20)
                                      for _ in range(args.windows)])
    out["fast_device_busy_ms_per_cycle"] = busy_ms(cycle)
    out["fast_peak_mem_bytes"] = torch.cuda.max_memory_allocated()

    kern = {}
    xa, xc = rand(A.n_rows, 5), rand(fast.Ac.n, 6)
    kern["k1_A"] = kernel_row(lambda: fast.A.matvec(xa))
    kern["k1_Ac"] = kernel_row(lambda: fast.Ac.matvec(xc))
    xp = rand(fast.P.shape[1], 7)
    kern["k2_P"] = kernel_row(lambda: fast.P.fwd(xp))
    kern["k2_Pt"] = kernel_row(lambda: fast.P.bwd(xa))

    def pcg():
        amg_pcg(fast, b, x0, n_iters=10, flip_sign=True)
    window(pcg, 1)
    out["amg_pcg_ms_per_iter"] = stats([window(pcg, 1) / 10
                                        for _ in range(args.windows)])
    out["amg_pcg_device_busy_ms_per_iter"] = busy_ms(pcg) / 10
    del fast

    mg = setup_with_dia_multigrid(setup_sa_multigrid(A, seed=0),
                                  kernel=True)

    def mgp():
        mg_pcg(mg, b, x0, n_iters=30, flip_sign=True)
    window(mgp, 1)
    out["mg_pcg_ms_per_iter"] = stats([window(mgp, 1) / 30
                                       for _ in range(args.windows)])
    out["mg_pcg_device_busy_ms_per_iter"] = busy_ms(mgp) / 30
    del mg

    gs = (1024, 1024)

    def cycles(name, run):
        def cycle():
            run(b, x0)
        window(cycle, 3)
        out[f"{name}_ms_per_cycle"] = stats([window(cycle, 20)
                                             for _ in range(args.windows)])
        out[f"{name}_device_busy_ms_per_cycle"] = busy_ms(cycle)

    alt = setup_twogrid(A, theta=0.25, splitting="alternating")
    geo = GeometricVCycle(A, gs, setup=alt)
    cycles("geometric", geo.run)
    auto = AutoTwoGrid(setup_twogrid(A, theta=0.25, splitting="cljp",
                                     seed=0))
    cycles("stencil_auto", auto.run)
    x2, c2 = rand(gs, 8), rand(gs, 9)
    xc2 = rand(tuple(geo._ac_call.taps.shape[1:]), 10)
    jac16 = make_stencil_jacobi(A, gs, omega=0.7, n_iters=3, diag=alt.diag,
                                tap_dtype=torch.bfloat16)
    sp3 = make_stencil_spmv(A, gs, 3)
    _, planes_t = stencil_transpose(sp3.shifts, sp3.taps)
    spmv_t = StencilCall(sp3.shifts_t, planes_t.contiguous(), 3, "plain")
    kern["k4_Ac_plain"] = kernel_row(lambda: geo._ac_call(xc2))
    kern["k4_jacobi_affine"] = kernel_row(lambda: geo._pre._call(x2, c2))
    kern["k4_residual_affine"] = kernel_row(lambda: geo._res._call(x2, c2))
    kern["k4_jacobi_affine_bf16"] = kernel_row(lambda: jac16._call(x2, c2))
    kern["k4_plain_3step_T"] = kernel_row(lambda: spmv_t(x2))
    del geo, auto, alt, jac16, sp3, spmv_t, planes_t

    rows, cols, vals = A.host_coo()
    new = np.argsort(np.random.default_rng(0).permutation(A.n_rows))
    A_p = SparseOperator.from_coo(new[rows], new[cols], vals, A.shape,
                                  device=dev)
    leg = AutoTwoGrid(setup_twogrid(A_p, theta=0.25, splitting="cljp",
                                    seed=0))
    assert leg.layout == "stream", leg.why
    cycles("stream_auto", leg.run)
    S = leg.setup.A
    xk = rand(A.n_rows, 11)
    kern["k2_A_rcm"] = kernel_row(lambda: S.fwd(xk))
    kern["k2_A_rcm_T"] = kernel_row(lambda: S.bwd(xk))
    out["kernels_flushed_ms"] = kern
    del leg, S
    csr = A_p.to_scipy()
    csr.sort_indices()
    B, perm = rcm_csr(csr)
    B_n = (-B).tocsr()
    B_n.sort_indices()
    n = A.n_rows
    mm_n, _ = csr_pair(B_n, dev, width=n)
    p = torch.from_numpy(perm.astype(np.int64)).to(dev)
    probes_k = torch.from_numpy(uniform_probes(
        n, 20, np.random.default_rng(29)).astype(np.float32)).to(dev)[p]
    probes_k = probes_k.contiguous()
    d0 = -A_p.diagonal()

    def gelfand():
        d = d0.clone().requires_grad_(True)
        loss = damping_factor_gelfand_spmm(mm_n, d[p], 2.0 / 3.0,
                                           probes_k, k=3)
        torch.autograd.grad(loss, d)
    window(gelfand, 2)
    out["gelfand_ms_per_value_and_grad"] = stats(
        [window(gelfand, 5) for _ in range(args.windows)])
    out["gelfand_device_busy_ms"] = busy_ms(gelfand)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(dict(tree=tree, nvidia_smi=smi, **out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
