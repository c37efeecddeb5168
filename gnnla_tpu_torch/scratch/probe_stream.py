"""y = A x on two 1024-row tiles of random edges — the twin of
scratch/probe_stream.py.

    python -m gnnla_tpu_torch.scratch.probe_stream [--cpu]

The script probed the TPU stream kernel's building blocks (window DMA,
superchunk select, gather, deposit, one-hot routing) on 2048 rows with 5
random (column, value) edges each (numpy seed 3), checked against the
dense A @ x. That function is an ELL matrix with K = 5: the twin runs it
on K6 through `from_slots` (each edge its own slot, duplicate columns
kept apart) and on K2 over the CSR (duplicates summed), and holds both to
the script's limit, a relative error below 1e-5. No kernel of its own.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from gnnla_tpu_torch.ops.ellw_spmv import EllwSpMV, from_slots
from gnnla_tpu_torch.ops.stream_spmv import CsrSpMV
from gnnla_tpu_torch.scratch._common import (device, ms_per_call, parser,
                                             say, where)

TILE = 1024
NSUB = 8      # the TPU pack's groups (sublanes) per block
MAXMULT = 4   # the TPU pack's deposit passes
N_ROWS = 2 * TILE
K_EDGES = 5


def fixture(seed: int = 3):
    """(cols [n, 5], vals [n, 5], dense A, x) as probe_stream.py:185-245
    draws them: A[r, cols[r, k]] += vals[r, k] in float32."""
    rng = np.random.default_rng(seed)
    n = N_ROWS
    cols = rng.integers(0, n, size=(n, K_EDGES))
    vals = rng.standard_normal((n, K_EDGES)).astype(np.float32)
    A = np.zeros((n, n), np.float32)
    for k in range(K_EDGES):
        np.add.at(A, (np.arange(n), cols[:, k]), vals[:, k])
    x = rng.standard_normal(n).astype(np.float32)
    return cols, vals, A, x


def run(dev: torch.device, *, iters: int = 20, verbose: bool = True) -> dict:
    """K6 and K2 on the fixture against the dense A @ x; each is launched
    1 + 1 + iters times (check, warm-up, timing)."""
    cols, vals, A, x = fixture()
    n = N_ROWS
    ell = EllwSpMV(from_slots(cols, vals), device=dev)
    csr_host = sp.csr_matrix((vals.reshape(-1), (np.repeat(np.arange(n),
                                                           K_EDGES),
                                                 cols.reshape(-1))),
                             shape=(n, n))
    csr_host.sort_indices()
    csr = CsrSpMV(csr_host, device=dev)
    xt = torch.from_numpy(x).to(dev)
    expect = A @ x
    out = dict(ell=ell, csr=csr, x=xt, W=ell.W, K=ell.K)
    for name, fn in (("K6 (windowed ELL)", ell.matvec), ("K2 (CSR)", csr)):
        y = fn(xt).cpu().numpy()
        err = float(np.abs(y - expect).max() / np.abs(expect).max())
        ms = ms_per_call(lambda: fn(xt), dev, iters)
        if verbose:
            say(f"stream-kernel probe rel err: {err:.2e}  [{name}, "
                f"{ms:.4f} ms per launch, {where(dev)}]")
        if not err < 1e-5:
            raise AssertionError(f"probe_stream: MISMATCH on {name}: "
                                 f"{err:.2e}")
        out["K6" if name.startswith("K6") else "K2"] = dict(
            y=y, rel_err=err, ms=ms)
    if verbose:
        say("OK")
    return out


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    return run(device(args))


if __name__ == "__main__":
    main()
