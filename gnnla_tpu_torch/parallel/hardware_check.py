"""The sharded kernels' check on the ranks there are — the counterpart of
gnnla_tpu/parallel/hardware_check.py.

`run_sharded_hardware_check` builds a row mesh over every rank of the
process group, runs each sharded family on the card (or, asked for, on
the CPU) and holds it against a host oracle. With `min_halo_tiles=1` the
stream shards keep their ring exchange even on a 1-rank mesh, so the
program the card runs is the multi-rank one:

  1. sharded K2 SpMV            against scipy's A @ x
  2. sharded K2 VJP             x cotangent against A^T ybar, and the
                                values cotangent's sum against the host
                                pattern sum (order-free)
  3. sharded K2 V-cycle         against the single-device `solve`
  4. sharded stencil matvec     against the COO matvec

Every rank runs the same checks; each raises on a mismatch.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from gnnla_tpu_torch._device import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_sharded_hardware_check(*, device="cuda", mesh=None,
                               n_stream: int = 181, n_vcycle: int = 96,
                               n_stencil: int = 128,
                               n_timing_iters: int = 50) -> dict:
    """Run every sharded family on `device` (the card by default) on a row
    mesh over all ranks (`mesh`, or `global_row_mesh()` of an initialized
    process group) and assert parity. Returns a metrics dict; raises on
    any numerics mismatch."""
    from gnnla_tpu_torch.parallel import (build_sharded_stream,
                                          global_row_mesh,
                                          make_sharded_stencil_matvec,
                                          make_sharded_stream_vcycle,
                                          shard_planes, shard_vec2d)
    from gnnla_tpu_torch.parallel.collectives import axis_group, psum
    from gnnla_tpu_torch.parallel.distributed import (gather_vector,
                                                      mesh_device)
    from gnnla_tpu_torch.problems import laplacian_2d

    resolve_device(device)
    mesh = global_row_mesh(device_type=torch.device(device).type) \
        if mesh is None else mesh
    dev = mesh_device(mesh)
    group = axis_group(mesh, "rows")
    out = {"ndev": dist.get_world_size(group),
           "backend": dist.get_backend(group), "device": str(dev)}

    # ---- 1+2: sharded K2 SpMV and its VJP -------------------------------
    op = laplacian_2d(n_stream, device=dev).eliminate_zeros().scale(
        1.0 / 8.0)
    A = op.to_scipy().tocsr()
    rng = np.random.default_rng(24601)
    x = rng.standard_normal(op.n_rows).astype(np.float32)
    w = rng.standard_normal(op.n_rows).astype(np.float32)

    t0 = time.perf_counter()
    kern = build_sharded_stream(op, mesh, "rows", with_grad=True,
                                min_halo_tiles=1)
    out["stream_build_s"] = time.perf_counter() - t0
    if kern.h_tiles < 1:  # the ring exchange must be in the program
        raise AssertionError(f"h_tiles {kern.h_tiles} < 1")

    y = kern.matvec(x)
    y_ref = A @ x
    err = np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref)
    out["stream_spmv_rel_err"] = float(err)
    if not err < 1e-5:
        raise AssertionError(f"sharded stream SpMV mismatch: {err}")

    # timing: chained applies on this rank's block
    x_l = kern.shard(kern.to_padded(x))
    kern.apply(x_l)
    _sync(dev)
    t0 = time.perf_counter()
    z = x_l
    for _ in range(n_timing_iters):
        z = kern.apply(z)
    _sync(dev)
    dt = time.perf_counter() - t0
    out["stream_spmv_edges_per_s"] = kern.nnz * n_timing_iters / dt

    # VJP: L = <A x, w>  =>  dL/dx = A^T w; the values cotangent's sum is
    # the (order-free) pattern sum of w_i x_j
    w_l = kern.shard(kern.to_padded(w))
    vals = kern.diff_args.detach().clone().requires_grad_(True)
    x_g = x_l.clone().requires_grad_(True)
    loss = torch.sum(kern.apply_diff(vals, x_g) * w_l)
    dvals, gx = torch.autograd.grad(loss, (vals, x_g))
    xbar = kern.from_padded(kern.gather(gx))
    xbar_ref = A.T @ w
    gerr = np.linalg.norm(xbar - xbar_ref) / np.linalg.norm(xbar_ref)
    out["stream_vjp_x_rel_err"] = float(gerr)
    if not gerr < 1e-5:
        raise AssertionError(f"sharded stream VJP x-cotangent mismatch: "
                             f"{gerr}")
    d64 = dvals.double()
    slot_sum = float(psum(d64.sum(), group))
    denom = max(float(psum(d64.abs().sum(), group)), 1e-30)
    coo = A.tocoo()
    ref_sum = float(np.sum(w[coo.row].astype(np.float64)
                           * x[coo.col].astype(np.float64)))
    out["stream_vjp_vals_sum_rel_err"] = abs(slot_sum - ref_sum) / denom
    if not out["stream_vjp_vals_sum_rel_err"] < 1e-5:
        raise AssertionError(f"values-cotangent sum mismatch: {slot_sum} "
                             f"vs {ref_sum}")

    # ---- 3: sharded K2 V-cycle ------------------------------------------
    from gnnla_tpu_torch.models.vcycle import setup_twogrid, solve

    opv = laplacian_2d(n_vcycle, device=dev).eliminate_zeros()
    setup = setup_twogrid(opv, splitting="cljp", seed=0)
    cycle, vkern = make_sharded_stream_vcycle(setup, mesh, min_halo_tiles=1)
    b = np.ones(opv.n_rows, np.float32)
    b_l = vkern.shard(vkern.to_padded(b))
    x_lv = torch.zeros_like(b_l)
    for _ in range(3):
        x_lv = cycle(b_l, x_lv)
    x_sh = vkern.from_padded(vkern.gather(x_lv))
    x_1dev = solve(setup, torch.from_numpy(b).to(dev),
                   torch.zeros(opv.n_rows, device=dev),
                   n_cycles=3).cpu().numpy()
    verr = np.linalg.norm(x_sh - x_1dev) / np.linalg.norm(x_1dev)
    out["stream_vcycle_rel_err"] = float(verr)
    if not verr < 1e-4:
        raise AssertionError(f"sharded stream V-cycle mismatch: {verr}")
    r = b - opv.to_scipy().tocsr() @ x_sh
    out["stream_vcycle_res_reduction"] = float(
        np.linalg.norm(r) / np.linalg.norm(b))
    # the parity above is the check; this guards against a cycle that
    # diverges outright
    if not out["stream_vcycle_res_reduction"] < 1.0:
        raise AssertionError("sharded V-cycle did not reduce the residual")

    # ---- 4: sharded stencil matvec --------------------------------------
    from gnnla_tpu_torch.ops.stencil import stencil_taps

    ops_ = laplacian_2d(n_stencil, device=dev)
    shifts, planes = stencil_taps(ops_, (n_stencil, n_stencil))
    planes = planes.reshape(-1, n_stencil, n_stencil).astype(np.float32)
    xs = rng.standard_normal((n_stencil, n_stencil)).astype(np.float32)
    mv = make_sharded_stencil_matvec(shifts, (n_stencil, n_stencil), mesh)
    y_l = mv(shard_planes(planes, mesh), shard_vec2d(xs, mesh))
    y_st = gather_vector(y_l, mesh).reshape(-1).cpu().numpy()
    y_st_ref = ops_.matvec(torch.from_numpy(xs.ravel()).to(dev)).cpu(
        ).numpy()
    serr = (np.linalg.norm(y_st - y_st_ref)
            / max(np.linalg.norm(y_st_ref), 1e-30))
    out["stencil_rel_err"] = float(serr)
    if not serr < 1e-5:
        raise AssertionError(f"sharded stencil matvec mismatch: {serr}")

    out["ok"] = True
    return out


if __name__ == "__main__":
    # python -m gnnla_tpu_torch.parallel.hardware_check [--n-stream N]
    # alone (one rank) or under torchrun --nproc-per-node N; rank 0 prints
    import argparse
    import json

    from gnnla_tpu_torch.parallel import launched_ranks

    parser = argparse.ArgumentParser(
        prog="gnnla_tpu_torch.parallel.hardware_check")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--n-stream", type=int, default=181,
                        help="side of the stream family's grid")
    args = parser.parse_args()
    with launched_ranks(args.device) as dev:
        res = run_sharded_hardware_check(device=dev.type,
                                         n_stream=args.n_stream)
        if dist.get_rank() == 0:
            print(json.dumps(res))
