"""Rank processes for tests/test_torch_parallel*.py: each rank of a gloo
world runs every case of one suite and saves its results per rank, for
the tests (in the pytest process) to hold against the JAX package.

This module holds no test and imports only the port, torch, numpy and
scipy, so the spawned ranks never import JAX. Every case draws its inputs
from fixed numpy seeds that the tests repeat on the JAX side.

    start(suite, world, run_dir) -> ProcessContext    (spawned ranks)
    join(ctx, timeout) -> None | str                   (error text)
    result(run_dir, suite, world, case, rank=0) -> dict of arrays

and `rank_or_raise`, `sleep_then_rank`: functions for `spawn_ranks` to
run on its ranks.
"""

from __future__ import annotations

import os
import time
import traceback

import numpy as np
import torch

CPU = "cpu"


# ------------------------------------------------------------ fixtures
def laplacian(n):
    from gnnla_tpu_torch.problems import laplacian_2d
    return laplacian_2d(n, device=CPU)


def banded_unstructured(n, k, seed, scramble=True):
    """tests/test_parallel_stream.py's operator: nonsymmetric, random
    values, bandwidth k, rows scrambled so RCM has work to do."""
    from scipy import sparse as sp

    rng = np.random.default_rng(seed)
    idx = np.arange(n)
    rows = np.concatenate([idx] * k)
    cols = np.concatenate([np.clip(idx + off, 0, n - 1)
                           for off in range(-(k // 2), k // 2 + 1)])
    vals = rng.standard_normal(rows.size).astype(np.float32)
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    A.sum_duplicates()
    if scramble:
        p = rng.permutation(n)
        A = A[p][:, p].tocsr()
    A.sort_indices()
    return A


def scrambled_laplacian(n_grid, seed=0):
    """laplacian_2d(n_grid) with its vertices permuted (host CSR), and the
    generator that drew the permutation."""
    A = laplacian(n_grid).eliminate_zeros()
    rng = np.random.default_rng(seed)
    p = rng.permutation(A.n_rows)
    Ah = A.to_scipy().tocsr()[p][:, p].tocsr()
    Ah.sort_indices()
    return Ah, rng


def wide_band(n=8192, seed=4):
    """A uniformly random pattern: its RCM bandwidth is ~n."""
    from scipy import sparse as sp

    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, 40000)
    cols = rng.integers(0, n, 40000)
    A = sp.csr_matrix((np.ones(40000, np.float32), (rows, cols)),
                      shape=(n, n))
    return (A + sp.identity(n, np.float32)).tocsr()


def raised(fn) -> str:
    """The name of the exception fn raises ("" when none)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the type is the result
        return type(e).__name__ + ": " + str(e)
    return ""


# -------------------------------------------------------- suite "core"
def _vec(mesh, v, part):
    from gnnla_tpu_torch.parallel import local_block, shard_vector
    return local_block(shard_vector(np.asarray(v, np.float32), part), mesh)


def _whole(mesh, v_local, part):
    from gnnla_tpu_torch.parallel import gather_vector, unshard_vector
    return unshard_vector(gather_vector(v_local, mesh), part).numpy()


def case_matvec(mesh, run_dir):
    from gnnla_tpu_torch.parallel import make_sharded_matvec, partition_rows
    out = {}
    for key, A in (("A16", laplacian(16)), ("A5", laplacian(5))):
        part = partition_rows(A, mesh.size())
        x = np.random.default_rng(24601).random(A.n_rows)
        out[key] = _whole(mesh, make_sharded_matvec(part, mesh)(
            _vec(mesh, x, part)), part)
    # a scrambled pattern that reaches beyond the ring: the all-gather path
    from gnnla_tpu_torch.ops.sparse import SparseOperator
    Ah, _ = scrambled_laplacian(16, seed=3)
    A = SparseOperator.from_scipy(Ah, device=CPU)
    part = partition_rows(A, mesh.size())
    x = np.random.default_rng(24601).random(A.n_rows)
    out["scrambled"] = _whole(mesh, make_sharded_matvec(part, mesh)(
        _vec(mesh, x, part)), part)
    out["scrambled_reach"] = np.asarray(part.halo_reach)
    return out


def case_jacobi_norm_power(mesh, run_dir):
    from gnnla_tpu_torch.parallel import (make_sharded_jacobi,
                                          make_sharded_norm,
                                          make_sharded_power_method,
                                          partition_rows)
    A = laplacian(16)
    part = partition_rows(A, mesh.size())
    rng = np.random.default_rng(24601)
    b, x0 = rng.random(256), rng.random(256)
    jac = make_sharded_jacobi(part, mesh)
    x = jac(_vec(mesh, b, part), _vec(mesh, x0, part),
            _vec(mesh, A.host_diagonal(), part), 0.7, 10)
    nrm = make_sharded_norm(part, mesh)(_vec(mesh, x0, part))
    lam, bl = make_sharded_power_method(part, mesh)(_vec(mesh, x0, part), 30)
    return {"jacobi": _whole(mesh, x, part), "norm": nrm.numpy(),
            "lam": lam.numpy(), "power_b": _whole(mesh, bl, part)}


def case_collectives(mesh, run_dir):
    """ring_shift both ways and its backward, psum, pmax, all-gather,
    axis_index/size, to_global, replicate_global, the mesh helpers."""
    import torch.distributed as dist

    from gnnla_tpu_torch.parallel import (global_row_mesh, grid_mesh,
                                          replicate_global, to_global)
    from gnnla_tpu_torch.parallel.collectives import (all_gather_tiled,
                                                      axis_group,
                                                      axis_index, axis_size,
                                                      pmax, psum,
                                                      ring_shift)
    g = axis_group(mesh, "rows")
    i, n = axis_index(g), axis_size(g)
    x = torch.arange(3.0) + 10 * i
    xr = x.clone().requires_grad_(True)
    w = torch.arange(3.0) * (i + 1)
    torch.sum(w * ring_shift(xr, 1, g)).backward()
    m = grid_mesh((2, n // 2), ("data", "rows"))
    tree = {"a": np.arange(2 * n).reshape(n, 2), "s": np.asarray(5.0)}
    return {
        "index": np.asarray(i), "size": np.asarray(n),
        "right": ring_shift(x, 1, g).numpy(),
        "left": ring_shift(x, -1, g).numpy(),
        "full": ring_shift(x, n, g).numpy(),
        "grad": xr.grad.numpy(),
        "psum": psum(x, g).numpy(), "pmax": pmax(x, g).numpy(),
        "gather": all_gather_tiled(x, g).numpy(),
        "to_global": to_global(tree, mesh)["a"].numpy(),
        "to_global_scalar": to_global(tree, mesh)["s"].numpy(),
        "replicate": replicate_global(tree, mesh)["a"].numpy(),
        "row_mesh": np.asarray(global_row_mesh().shape),
        "grid_mesh": np.asarray(m.shape),
        "grid_names": np.asarray(m.mesh_dim_names),
        "bad_grid": np.asarray(raised(lambda: grid_mesh((3, 3)))),
        "world": np.asarray(dist.get_world_size())}


def case_vcycles(mesh, run_dir):
    from gnnla_tpu_torch.models.multigrid import (setup_sa_multigrid,
                                                  setup_with_dia_multigrid)
    from gnnla_tpu_torch.models.vcycle import setup_twogrid, setup_with_dia
    from gnnla_tpu_torch.parallel import (make_sharded_multigrid_cycle,
                                          make_sharded_vcycle)
    out = {}
    A = laplacian(16)
    setup = setup_twogrid(A, theta=0.25, splitting="cljp", seed=0)
    rng = np.random.default_rng(24601)
    b, x0 = rng.random(256), rng.random(256)
    cycle, part = make_sharded_vcycle(setup, mesh, n_pre=2, n_post=2,
                                      coarse_deg=3)
    bl, xl = _vec(mesh, b, part), _vec(mesh, x0, part)
    for k in range(3):
        xl = cycle(bl, xl)
        out[f"twogrid_{k}"] = _whole(mesh, xl, part)
    out["twogrid_guard"] = np.asarray(raised(
        lambda: make_sharded_vcycle(setup_with_dia(setup), mesh)))

    A48 = laplacian(48)
    sa = setup_sa_multigrid(A48, min_coarse=16)
    rng = np.random.default_rng(24601)
    b, x0 = rng.random(A48.n_rows), rng.random(A48.n_rows)
    for gamma in (1, 2):
        cycle, part = make_sharded_multigrid_cycle(
            sa, mesh, n_pre=2, n_post=2, coarse_deg=4, gamma=gamma,
            n_sharded_levels=2)
        bl, xl = _vec(mesh, b, part), _vec(mesh, x0, part)
        for k in range(3):
            xl = cycle(bl, xl)
            out[f"mg{gamma}_{k}"] = _whole(mesh, xl, part)

    A32 = laplacian(32)
    sa32 = setup_sa_multigrid(A32, min_coarse=16)
    b = np.random.default_rng(7).random(A32.n_rows)
    cycle, part = make_sharded_multigrid_cycle(sa32, mesh, n_pre=1, n_post=1,
                                               coarse_deg=4)
    bl, xl = _vec(mesh, b, part), _vec(mesh, np.zeros(A32.n_rows), part)
    for _ in range(4):
        xl = cycle(bl, xl)
    out["auto"] = _whole(mesh, xl, part)
    out["auto_guard"] = np.asarray(raised(lambda: make_sharded_multigrid_cycle(
        setup_with_dia_multigrid(sa32), mesh)))
    return out


def case_mg_pcg(mesh, run_dir):
    from gnnla_tpu_torch.models.multigrid import setup_sa_multigrid
    from gnnla_tpu_torch.parallel import make_sharded_mg_pcg
    A = laplacian(48)
    setup = setup_sa_multigrid(A, min_coarse=16)
    b = np.random.default_rng(24601).random(A.n_rows)
    solve, part = make_sharded_mg_pcg(setup, mesh, flip_sign=True,
                                      n_sharded_levels=2)
    x, hist = solve(_vec(mesh, b, part),
                    _vec(mesh, np.zeros(A.n_rows), part), 10)
    return {"x": _whole(mesh, x, part), "hist": hist}


def case_stencil(mesh, run_dir):
    from gnnla_tpu_torch.ops.stencil import stencil_taps
    from gnnla_tpu_torch.parallel import (gather_vector,
                                          make_sharded_stencil_jacobi,
                                          make_sharded_stencil_matvec,
                                          shard_planes, shard_vec2d)
    from gnnla_tpu_torch.problems.laplacian import laplacian_nd

    def fixture(n, periodic=False):
        A = (laplacian_nd([n, n], bcs=[1, 1], device=CPU)[0] if periodic
             else laplacian(n))
        shifts, planes = stencil_taps(A, (n, n))
        return A, shifts, planes.reshape(-1, n, n).astype(np.float32)

    def whole(y_l):
        g = gather_vector(y_l, mesh)
        return g.reshape((-1,) + tuple(g.shape[2:])).numpy()

    out = {}
    S = mesh.size()
    for periodic in (False, True):
        _, shifts, planes = fixture(32, periodic)
        x = np.random.default_rng(0).standard_normal((32, 32))
        mv = make_sharded_stencil_matvec(shifts, (32, 32), mesh)
        out[f"matvec_{int(periodic)}"] = whole(mv(
            shard_planes(planes, mesh),
            shard_vec2d(x.astype(np.float32), mesh)))
    _, shifts, planes = fixture(16)
    x = np.random.default_rng(1).standard_normal((16, 16, 3))
    mv = make_sharded_stencil_matvec(shifts, (16, 16), mesh)
    out["probe"] = whole(mv(shard_planes(planes, mesh),
                            shard_vec2d(x.astype(np.float32), mesh)))
    A, shifts, planes = fixture(32)
    b = np.random.default_rng(2).standard_normal((32, 32)).astype(
        np.float32)
    d2 = A.host_diagonal().reshape(32, 32).astype(np.float32)
    jac = make_sharded_stencil_jacobi(shifts, (32, 32), mesh)
    out["jacobi"] = whole(jac(
        shard_planes(planes, mesh), shard_vec2d(d2, mesh),
        shard_vec2d(b, mesh), shard_vec2d(np.zeros_like(b), mesh), 0.7, 5))
    bad = 4 * S + 1
    out["bad_grid"] = np.asarray(raised(lambda: make_sharded_stencil_matvec(
        shifts, (bad, bad), mesh)))
    # a row reach of 2 on 1-row shards
    out["bad_reach"] = np.asarray(raised(lambda: make_sharded_stencil_matvec(
        [(0, 0), (2, 0)], (S, 8), mesh)))
    return out


# ------------------------------------------------------ suite "stream"
def _stream_x(kern, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(kern.n).astype(np.float32),
            rng.standard_normal(kern.n).astype(np.float32))


def case_stream(mesh, run_dir):
    from gnnla_tpu_torch.parallel import (build_sharded_stream,
                                          stream_scaling_model)
    out = {}
    A = banded_unstructured(9000, 9, seed=0)
    kern = build_sharded_stream(A, mesh, "rows")
    x = np.random.default_rng(1).standard_normal(9000).astype(np.float32)
    out["y"] = kern.matvec(x)
    out["h_tiles"] = np.asarray(kern.h_tiles)
    out["t_global"] = np.asarray(kern.t_global)
    out["nnz"] = np.asarray(kern.nnz)
    out["perm"] = kern.perm
    m = stream_scaling_model(kern)
    out["model"] = np.asarray([m["ndev"], m["local_bytes_per_chip"],
                               m["comm_bytes_per_chip"],
                               m["efficiency_serial"],
                               m["efficiency_overlapped"],
                               m["edges_per_s_aggregate"]])
    out["launches"] = np.asarray(kern.fwd.launches)  # the CPU runs none

    A = banded_unstructured(8192, 5, seed=2)
    A = (A * (0.2 / np.abs(A).sum(axis=1).max())).tocsr()
    kern = build_sharded_stream(A, mesh, "rows")
    x = np.random.default_rng(3).standard_normal(8192).astype(np.float32)
    z = kern.shard(kern.to_padded(x))
    for _ in range(3):
        z = kern.apply(z)
    out["chained"] = kern.from_padded(kern.gather(z))

    out["wide"] = np.asarray(raised(
        lambda: build_sharded_stream(wide_band(), mesh, "rows")))
    out["min_halo"] = np.asarray(build_sharded_stream(
        banded_unstructured(9000, 3, seed=0, scramble=False), mesh, "rows",
        min_halo_tiles=1).h_tiles)
    return out


def case_stream_vjp(mesh, run_dir):
    from gnnla_tpu_torch.parallel import build_sharded_stream
    from gnnla_tpu_torch.parallel.collectives import axis_group, axis_index
    out = {}
    A = banded_unstructured(9000, 9, seed=2)
    kern = build_sharded_stream(A, mesh, "rows", with_grad=True)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(9000).astype(np.float32)
    w = rng.standard_normal(9000).astype(np.float32)
    x_l = kern.shard(kern.to_padded(x)).requires_grad_(True)
    w_l = kern.shard(kern.to_padded(w))
    y = kern.apply_diff(kern.diff_args, x_l)
    out["fwd_gap"] = np.asarray(float(
        (y.detach() - kern.apply(x_l.detach())).abs().max()))
    torch.sum(w_l * y).backward()
    out["xbar"] = kern.from_padded(kern.gather(x_l.grad))
    out["h_tiles"] = np.asarray(kern.h_tiles)

    # the values' cotangent per CSR entry of each shard, with the entry's
    # global (row, col) in the padded kernel order
    A = banded_unstructured(6000, 7, seed=4)
    kern = build_sharded_stream(A, mesh, "rows", with_grad=True)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(6000).astype(np.float32)
    w = rng.standard_normal(6000).astype(np.float32)
    vals = kern.diff_args.detach().clone().requires_grad_(True)
    x_l = kern.shard(kern.to_padded(x))
    w_l = kern.shard(kern.to_padded(w))
    torch.sum(w_l * kern.apply_diff(vals, x_l)).backward()
    d = axis_index(axis_group(mesh, "rows"))
    R = kern.rows_per_shard
    rp = kern.fwd.row_ptr.long()
    rows = torch.repeat_interleave(torch.arange(R), rp.diff())
    out["dv_row"] = (d * R + rows).numpy()
    out["dv_col"] = (kern.fwd.cols.long() + d * R
                     - kern.h_tiles * 1024).numpy()
    out["dv"] = vals.grad.numpy()
    out["perm"] = kern.perm
    out["padded_len"] = np.asarray(kern.padded_len)
    return out


def case_stream_vcycle(mesh, run_dir):
    from gnnla_tpu_torch.models.vcycle import setup_twogrid
    from gnnla_tpu_torch.ops.sparse import SparseOperator
    from gnnla_tpu_torch.parallel import make_sharded_stream_vcycle
    Ah, rng = scrambled_laplacian(96, seed=0)
    A = SparseOperator.from_scipy(Ah, device=CPU)
    setup = setup_twogrid(A, theta=0.25, splitting="pmis", seed=0)
    b = rng.standard_normal(A.n_rows).astype(np.float32)
    x0 = rng.standard_normal(A.n_rows).astype(np.float32)
    cycle, kern = make_sharded_stream_vcycle(setup, mesh, "rows")
    b_l = kern.shard(kern.to_padded(b))
    x_l = kern.shard(kern.to_padded(x0))
    for _ in range(2):
        x_l = cycle(b_l, x_l)
    return {"x": kern.from_padded(kern.gather(x_l)),
            "h_tiles": np.asarray(kern.h_tiles)}


def case_hardware_check(mesh, run_dir):
    from gnnla_tpu_torch.parallel.hardware_check import \
        run_sharded_hardware_check
    res = run_sharded_hardware_check(device=CPU, mesh=mesh, n_stream=96,
                                     n_vcycle=64, n_stencil=48,
                                     n_timing_iters=2)
    return {k: np.asarray(v) for k, v in res.items()}


# ------------------------------------------------------- suite "train"
TRAIN_JACOBI = dict(num_matrices=16, n_mesh=10, epochs=3, batch_size=8,
                    n_train=12, n_val=2, n_test=2, m_probes=8,
                    cache_dir=None, log_every=0)
TRAIN_DIFFUSION = dict(num_matrices=16, n_mesh=8, epochs=2, batch_size=4,
                       lr=1e-2, seed=41, cache_dir=None, log_every=0,
                       n_layers_external=1, n_layers_internal=2, n_hidden=8,
                       encoder=(3, 4))


def _history(h):
    return {k: np.asarray(h[k], np.float64)
            for k in ("train_loss", "val_loss", "test_loss")}


def case_train(mesh, run_dir):
    from torch.distributed.device_mesh import init_device_mesh

    from gnnla_tpu_torch.training import train_diffusion, train_jacobi
    from gnnla_tpu_torch.training.datasets import cosine_diffusion_dataset
    from gnnla_tpu_torch.training.train_diffusion import TrainDiffusionConfig
    from gnnla_tpu_torch.training.train_jacobi import TrainJacobiConfig
    S = mesh.size()
    data = init_device_mesh(CPU, (S,), mesh_dim_names=("data",))
    pj = torch.load(os.path.join(run_dir, "jacobi_init.pt"))
    pd = torch.load(os.path.join(run_dir, "diffusion_init.pt"))
    out = {}
    _, h = train_jacobi(TrainJacobiConfig(**TRAIN_JACOBI), mesh=data,
                        init_params=pj, device=CPU)
    out.update({f"jacobi_{k}": v for k, v in _history(h).items()})
    _, h = train_jacobi(TrainJacobiConfig(**TRAIN_JACOBI, n_devices=S),
                        init_params=pj, device=CPU)
    out.update({f"jacobi_nd_{k}": v for k, v in _history(h).items()})
    ds = cosine_diffusion_dataset(16, n=8, seed=41, device=CPU)
    _, h = train_diffusion(TrainDiffusionConfig(**TRAIN_DIFFUSION),
                           dataset=ds, init_params=pd, mesh=data, device=CPU)
    out.update({f"diffusion_{k}": v for k, v in _history(h).items()})
    bad = dict(TRAIN_JACOBI, batch_size=S * 2 + 1)
    out["indivisible"] = np.asarray(raised(lambda: train_jacobi(
        TrainJacobiConfig(**bad), mesh=data, device=CPU)))
    return out


# ------------------------------------------------------ suite "dryrun"
def case_dryrun(mesh, run_dir):
    import contextlib
    import io

    from gnnla_tpu_torch.parallel.dryrun import dryrun_multichip
    S = mesh.size()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = dryrun_multichip(S)
    out = {k: np.asarray(res[k]) for k in (
        "loss", "reference_loss", "loss_rel_gap", "param_max_abs_gap",
        "stencil_max_abs_err", "stream_max_abs_err",
        "stream_vcycle_max_abs_err", "mesh", "line", "n_st", "h_tiles",
        "k2_launches")}
    out["printed"] = np.asarray(buf.getvalue())
    out.update({f"param:{k}": v for k, v in res["params"].items()})
    out.update({f"reference:{k}": v
                for k, v in res["reference_params"].items()})
    out["wrong_world"] = np.asarray(raised(lambda: dryrun_multichip(S + 1)))
    return out


def case_psum_replicated(mesh, run_dir):
    """The gradient of a loss every rank computes from psum_replicated of
    its rows' squares, gathered: the one-process gradient's rows."""
    from gnnla_tpu_torch.parallel.collectives import (axis_group,
                                                      axis_index,
                                                      psum_replicated)
    g = axis_group(mesh, "rows")
    S, r = mesh.size(), axis_index(g)
    v = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (8 * S, 3)).astype(np.float32))
    v_l = v[r * 8:(r + 1) * 8].clone().requires_grad_(True)
    norms = torch.sqrt(psum_replicated(torch.sum(v_l * v_l, dim=0), g))
    loss = torch.amax(norms) ** (1.0 / 3.0)
    loss.backward()
    return {"loss": loss.detach().numpy(), "grad": v_l.grad.numpy(),
            "v": v.numpy()}


SUITES = {
    "core": [("matvec", case_matvec),
             ("jacobi_norm_power", case_jacobi_norm_power),
             ("collectives", case_collectives),
             ("vcycles", case_vcycles), ("mg_pcg", case_mg_pcg),
             ("stencil", case_stencil)],
    "stream": [("stream", case_stream), ("stream_vjp", case_stream_vjp),
               ("stream_vcycle", case_stream_vcycle),
               ("hardware_check", case_hardware_check)],
    "train": [("train", case_train)],
    "dryrun": [("dryrun", case_dryrun),
               ("psum_replicated", case_psum_replicated)],
}


# ------------------------------------- spawn_ranks (graft_entry tests)
def rank_or_raise(failing_rank: int) -> int:
    """This rank's number, or a ValueError on `failing_rank`."""
    import torch.distributed as dist
    rank = dist.get_rank()
    if rank == failing_rank:
        raise ValueError(f"rank {rank} of {dist.get_world_size()} fails")
    return rank


def sleep_then_rank(seconds: float) -> int:
    import torch.distributed as dist
    time.sleep(seconds)
    return dist.get_rank()


# ------------------------------------------------------------ the ranks
def _path(run_dir, suite, world, case, rank, ext="npz"):
    return os.path.join(run_dir, f"{suite}-{world}-{case}-{rank}.{ext}")


def run_rank(rank, world, suite, run_dir):
    """One rank: a gloo group through a file store in run_dir, every case
    of the suite, one npz per case. A case that raises ends the rank (the
    others then fail at their next collective)."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from gnnla_tpu_torch.parallel import (global_row_mesh,
                                          initialize_distributed)
    store = os.path.join(run_dir, f"store-{suite}-{world}")
    initialize_distributed(f"file://{store}", world, rank, device=CPU,
                           timeout=60)
    mesh = global_row_mesh()
    for name, fn in SUITES[suite]:
        t0 = time.perf_counter()
        try:
            res = fn(mesh, run_dir)
        except Exception:
            with open(_path(run_dir, suite, world, name, rank, "err"),
                      "w") as f:
                f.write(traceback.format_exc())
            raise
        res["seconds"] = np.asarray(time.perf_counter() - t0)
        np.savez(_path(run_dir, suite, world, name, rank),
                 **{k: np.asarray(v) for k, v in res.items()})
    dist.destroy_process_group()


def start(suite: str, world: int, run_dir: str):
    import torch.multiprocessing as mp
    return mp.start_processes(run_rank, args=(world, suite, run_dir),
                              nprocs=world, join=False,
                              start_method="spawn")


def join(ctx, timeout: float):
    """None when every rank ended well within `timeout` seconds, else the
    error; ranks still running are killed."""
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                return f"ranks still running after {timeout} s"
        return None
    except Exception as e:  # noqa: BLE001 — a rank's failure is reported
        return f"{type(e).__name__}: {e}"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)


def result(run_dir: str, suite: str, world: int, case: str,
           rank: int = 0) -> dict:
    path = _path(run_dir, suite, world, case, rank)
    if not os.path.exists(path):
        err = _path(run_dir, suite, world, case, rank, "err")
        raise AssertionError(
            f"rank {rank} of {world} has no result for {case!r}: " + (
                open(err).read() if os.path.exists(err)
                else "it never ran (an earlier case or rank failed)"))
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
