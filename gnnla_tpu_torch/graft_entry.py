"""The entry contract on PyTorch — the twin of the JAX repository's
`__graft_entry__.py`.

entry(device="cuda") -> (fn, (setup, b, x)): the flagship forward, one
    full two-grid AMG V-cycle on the 2-D FD Laplacian of 16 x 16 (256
    vertices), `fn(setup, b, x)`; eager, as the JAX `fn` is unjitted.
    `utils.program.program(fn)` is its jitted form: on the card one
    captured CUDA graph, replayed after the first call.
dryrun_multichip(n, *, device="cuda") -> dict: the multichip dry run
    (`parallel/dryrun.py`) as one call in one process: inside an
    initialized process group of n ranks it runs there; otherwise it
    spawns n ranks of its own and returns rank 0's results.

    python -m gnnla_tpu_torch.graft_entry [--device cpu]

runs `entry` once and prints the output's norm, as the JAX module's
`__main__` does, and beside it the norm of `program(fn)`'s output (on the
card a replay of the captured graph). Both functions run on the card
unless the caller passes device="cpu", and raise when it is asked for and
absent.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch
import torch.distributed as dist

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.models.vcycle import (setup_twogrid, setup_with_dia,
                                           vcycle)
from gnnla_tpu_torch.parallel import dryrun
from gnnla_tpu_torch.parallel.distributed import spawn_ranks
from gnnla_tpu_torch.problems import laplacian_2d
from gnnla_tpu_torch.utils.program import program

N_GRID = 16  # the 256-vertex fixture: the contract's whole width
DRYRUN_TIMEOUT_S = 600.0
# the dry run's objects that live on a rank's device and stay there
_RANK_ONLY = ("stream_kernel", "stream_vcycle_kernel")


def flagship_cycle(setup, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One two-grid cycle with the contract's parameters: 3 Jacobi sweeps
    before and after, a degree-4 Chebyshev coarse solve. Writes into none
    of its arguments. On the CPU two calls are bitwise equal; on the card
    the COO P's `index_add_` adds with atomics, so they agree to rounding."""
    return vcycle(setup, b, x, n_pre=3, n_post=3, coarse_deg=4)


def entry(device="cuda"):
    """(fn, (setup, b, x)), step for step as the JAX `entry`:
    `laplacian_2d(16)`, the CLJP two-grid setup (theta 0.25, seed 0),
    then `setup_with_dia`, and b then x drawn by `default_rng(0).random`
    and rounded to float32 by numpy.

    A and Ac run as the plain DIA operator (`DIAOperator.matvec`, shifted
    slices), not on kernel K1: the JAX entry calls `setup_with_dia` with
    its default `pallas=False`, so its cycle reaches no Pallas kernel and
    this one launches no hand-written kernel. P stays COO."""
    dev = resolve_device(device)
    A = laplacian_2d(N_GRID, device=dev)
    setup = setup_twogrid(A, theta=0.25, splitting="cljp", seed=0)
    setup = setup_with_dia(setup)
    rng = np.random.default_rng(0)
    n = A.n_rows
    b = torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.random(n).astype(np.float32)).to(dev)
    return flagship_cycle, (setup, b, x)


def _dryrun_rank(n_devices: int, device_type: str) -> dict:
    """A spawned rank's dry run; its results without the objects that
    live on its device, with the backend and the card tensors gloo
    staged through host memory."""
    from gnnla_tpu_torch.parallel import collectives

    res = dryrun.dryrun_multichip(n_devices, device_type=device_type)
    out = {k: v for k, v in res.items() if k not in _RANK_ONLY}
    out.update(backend=dist.get_backend(),
               staged_transfers=collectives.staged_transfers)
    return out


def dryrun_multichip(n_devices: int, *, device="cuda",
                     timeout: float = DRYRUN_TIMEOUT_S) -> dict:
    """The multichip dry run over `n_devices` ranks, in one call.

    In an initialized process group (which must hold `n_devices` ranks)
    this is `parallel.dryrun.dryrun_multichip` on this rank, and returns
    its results. Otherwise it spawns `n_devices` ranks on a file store in
    a temporary directory (`spawn_ranks`): on "cuda" rank r takes card r
    modulo the card count, over NCCL when every rank has a card of its
    own and over gloo when ranks share one; on "cpu" gloo ranks on the
    host. It then returns rank 0's results, less the two stream kernel
    objects that live in that rank's process, with `backend` and
    `staged_transfers` added. Rank 0 prints the JAX function's line. A
    rank that fails, or ranks that outlive `timeout` seconds, make the
    call raise with that rank's error."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return dryrun.dryrun_multichip(n_devices, device_type=dev.type)
    return spawn_ranks(_dryrun_rank, n_devices, (n_devices, dev.type),
                       device=dev, timeout=timeout)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="gnnla_tpu_torch.graft_entry")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    fn, example = entry(args.device)
    norm = float(torch.linalg.vector_norm(fn(*example)))
    run = program(fn)
    run(*example)  # on the card the warm-up, then the capture
    norm_p = float(torch.linalg.vector_norm(run(*example)))
    print("entry() vcycle output norm:", norm)
    print("program(fn) vcycle output norm:", norm_p)
    if not (math.isfinite(norm) and math.isfinite(norm_p)):
        print("the cycle's output is not finite", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
