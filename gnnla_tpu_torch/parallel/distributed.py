"""Process-group bring-up, meshes and the host-to-rank data path — the
counterpart of gnnla_tpu/parallel/distributed.py.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with one rank per
device (the counterpart of `jax.sharding.Mesh`); each axis is a process
group (`mesh.get_group(axis)`). The backend follows the device: NCCL for
the card, gloo for the CPU.

The data path: every process builds the same full host arrays
deterministically (the setup phase is host numpy throughout this
package), and each rank keeps only its own row of every [S, ...] array on
its own device (`to_global`, `local_block`); arrays every rank needs
whole go to the device as they are (`replicate_global`). A sharded
function takes and returns this rank's *local* block; `gather_vector`
all-gathers a result for a caller.

One call in one process can also start a world of its own:
`spawn_ranks` runs a function on n spawned ranks and returns rank 0's
result (`join_spawned` waits for spawned groups under one time limit).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import tempfile
import time
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.parallel.collectives import (all_gather_tiled,
                                                  axis_group, axis_index)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device="cuda", backend: Optional[str] = None,
                           timeout: Optional[float] = None) -> torch.device:
    """Start this process's rank and return its device.

    With no arguments the rank, world size and rendezvous come from the
    environment torchrun sets (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
    LOCAL_RANK), as `jax.distributed.initialize` auto-detects a pod.
    Otherwise pass all three: `coordinator_address` is "host:port" (a TCP
    rendezvous) or an init URL ("tcp://...", "file://..."). Call once per
    process. On the card each rank takes device LOCAL_RANK modulo the
    card count; the backend is NCCL there and gloo on the CPU unless
    `backend` names another. `timeout` (seconds) bounds how long a
    collective waits for the other ranks (torch's default otherwise)."""
    dev = resolve_device(device)
    given = (coordinator_address, num_processes, process_id)
    if any(a is None for a in given) and any(a is not None for a in given):
        raise ValueError("pass coordinator_address, num_processes and "
                         "process_id together, or none of them")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {} if timeout is None else {"timeout": timedelta(seconds=timeout)}
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url,
                                world_size=int(num_processes),
                                rank=int(process_id), **kw)
    return dev


@contextlib.contextmanager
def launched_ranks(device="cuda"):
    """The process group of this run, ended on exit; yields this rank's
    device. Under torchrun its ranks (from its environment); run alone, a
    world of one rank through a file store in a temporary directory."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as store:
        if "RANK" in os.environ:
            dev = initialize_distributed(device=dev)
        else:
            dev = initialize_distributed(
                f"file://{os.path.join(store, 'rendezvous')}", 1, 0,
                device=dev)
        try:
            yield dev
        finally:
            dist.destroy_process_group()


def join_spawned(ctxs: dict, timeout: float) -> dict:
    """Wait for each group of spawned processes (`ProcessContext`s by
    name) until `timeout` seconds have passed in all; {name: error} of
    the groups that failed or outlived it. Processes still running are
    killed."""
    errors = {}
    deadline = time.monotonic() + timeout
    for name, ctx in ctxs.items():
        try:
            while not ctx.join(timeout=max(1.0,
                                           deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    errors[name] = "timed out"
                    break
        except Exception as e:  # noqa: BLE001 — the caller re-raises
            errors[name] = f"{type(e).__name__}: {e}"[-4000:]
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
    return errors


def _spawned_rank(rank: int, fn, args: tuple, world: int, store: str,
                  out: str, device_type: str, backend: str,
                  timeout: float) -> None:
    """Rank `rank` of `spawn_ranks`: its process group, fn(*args), and on
    rank 0 the pickled return value in `out`."""
    os.environ["LOCAL_RANK"] = str(rank)  # the card: rank mod the count
    initialize_distributed(f"file://{store}", world, rank,
                           device=device_type, backend=backend,
                           timeout=timeout)
    try:
        res = fn(*args)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, args: tuple = (), *, device="cuda",
                timeout: float = 600.0):
    """Run fn(*args) on every rank of a new world of `world` spawned
    processes and return rank 0's return value (pickled across).

    The ranks meet through a file store in a temporary directory. On
    "cuda" rank r takes card r modulo the card count; the backend is NCCL
    when every rank has a card of its own and gloo when ranks share one
    (gloo stages card tensors through pinned host memory). On "cpu" they
    are gloo ranks on the host. `fn` must be importable by name (spawn
    pickles it). A rank that raises, or a world that outlives `timeout`
    seconds, makes the call raise with that rank's error."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    if world < 1:
        raise ValueError(f"need at least one rank, have {world}")
    backend = "gloo"
    if dev.type == "cuda" and world <= torch.cuda.device_count():
        backend = "nccl"
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pkl")
        ctx = mp.start_processes(
            _spawned_rank, args=(fn, tuple(args), world,
                                 os.path.join(tmp, "store"), out, dev.type,
                                 backend, timeout),
            nprocs=world, join=False, start_method="spawn")
        errors = join_spawned({"ranks": ctx}, timeout)
        if errors:
            raise RuntimeError(f"{world} spawned {backend} ranks failed: "
                               f"{errors['ranks']}")
        with open(out, "rb") as f:
            return pickle.load(f)


def _default_device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed "
                           "first (torchrun, or one rank per process)")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def global_row_mesh(axis: str = "rows", device_type: Optional[str] = None):
    """1-D mesh over every rank — the layout the row-partitioned kernels
    expect. `device_type` defaults to the backend's ("cuda" under NCCL,
    "cpu" under gloo); pass "cuda" for gloo ranks that share a card."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = device_type or _default_device_type()
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def grid_mesh(shape: Sequence[int],
              axis_names: Sequence[str] = ("data", "rows"),
              device_type: Optional[str] = None):
    """N-D mesh (e.g. data-parallel x row-sharded) over every rank."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = device_type or _default_device_type()
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {tuple(shape)} needs "
                         f"{int(np.prod(shape))} devices, have {world}")
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axis_names))


def mesh_device(mesh) -> torch.device:
    """This rank's device on `mesh`: the current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _tree_map(fn, tree):
    """fn on every array leaf of tuples, lists, dicts and dataclasses;
    other leaves (ints, floats, strings, None) are kept."""
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def local_block(xs, mesh, axis: str = "rows") -> torch.Tensor:
    """Row `axis_index` of an [S, ...] host array (or tensor), on this
    rank's device."""
    g = axis_group(mesh, axis)
    if xs.shape[0] != dist.get_world_size(g):
        raise ValueError(f"leading axis {xs.shape[0]} != the {axis!r} "
                         f"axis's {dist.get_world_size(g)} ranks")
    return _tensor(xs[axis_index(g)], mesh_device(mesh))


def to_global(tree, mesh, axis: str = "rows"):
    """Host-replicated tree of [S, ...] arrays -> this rank's blocks on
    its device (0-d arrays are kept whole). The twin of the JAX
    `to_global`: every process builds the same host arrays and keeps only
    its own shard."""
    def leaf(a):
        if a.ndim == 0:
            return _tensor(a, mesh_device(mesh))
        return local_block(a, mesh, axis)

    return _tree_map(leaf, tree)


def replicate_global(tree, mesh):
    """Host-replicated tree -> the same arrays whole on this rank's
    device (e.g. the replicated coarse tail of a multigrid cycle)."""
    dev = mesh_device(mesh)
    return _tree_map(lambda a: _tensor(a, dev), tree)


# the JAX package's name: place an [S, ...] array with its leading axis
# over the mesh axis, which for a rank is keeping its own block
device_put_sharded = local_block


def gather_vector(x_local: torch.Tensor, mesh,
                  axis: str = "rows") -> torch.Tensor:
    """The ranks' local blocks [R, ...] -> [S, R, ...] on every rank."""
    g = axis_group(mesh, axis)
    full = all_gather_tiled(x_local, g)
    return full.reshape((dist.get_world_size(g),) + tuple(x_local.shape))
