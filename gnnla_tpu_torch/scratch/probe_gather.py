"""Raw gather throughput of the ELL and COO SpMV formulations — the twin
of scratch/probe_gather.py, in plain PyTorch (the script had no kernel).

    python -m gnnla_tpu_torch.scratch.probe_gather [--n N] [--cpu]

For n vertices (default 1,048,576) and K = 8 random columns a row
(numpy seed 0): one flat gather x[cols], the ELL matvec as K gathers
(`ell_k`), as one 2-D gather (`ell_2d`), as `torch.take` (`ell_taa`), and
the COO matvec, gather then a segment sum (`coo`, index_add_). The four
SpMV forms must agree (relative to max|y|, 1e-5: their sums run in
different orders); each prints elements per second and ms per call.
"""

from __future__ import annotations

import numpy as np
import torch

from gnnla_tpu_torch.scratch._common import (device, ms_per_call, parser,
                                             say, where)

N_DEFAULT = 1 << 20
K = 8


def formulations(n: int):
    """name -> (function of the inputs, iterations): probe_gather.py
    :44-75 in PyTorch."""
    def flat(cols1d, rows, cols2d, vals2d, vals1d, x):
        return x[cols1d]

    def ell_k(cols1d, rows, cols2d, vals2d, vals1d, x):
        acc = vals2d[:, 0] * x[cols2d[:, 0]]
        for k in range(1, K):
            acc = acc + vals2d[:, k] * x[cols2d[:, k]]
        return acc

    def ell_2d(cols1d, rows, cols2d, vals2d, vals1d, x):
        return (vals2d * x[cols2d]).sum(dim=1)

    def coo(cols1d, rows, cols2d, vals2d, vals1d, x):
        return x.new_zeros(n).index_add_(0, rows, vals1d * x[cols1d])

    def ell_taa(cols1d, rows, cols2d, vals2d, vals1d, x):
        return (vals2d * torch.take(x, cols2d)).sum(dim=1)

    return {"flat gather E": (flat, 50), "ELL K-gathers": (ell_k, 50),
            "ELL 2D gather": (ell_2d, 50), "COO gather+segsum": (coo, 5),
            "ELL torch.take": (ell_taa, 50)}


def run(n: int, dev: torch.device, *, verbose: bool = True) -> dict:
    E = n * K
    rng = np.random.default_rng(0)
    cols2d = rng.integers(0, n, size=(n, K), dtype=np.int32)
    rows = np.repeat(np.arange(n, dtype=np.int32), K)
    vals2d = rng.standard_normal((n, K), dtype=np.float32) / K
    x = rng.standard_normal(n, dtype=np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        cols2d.reshape(-1).astype(np.int64), rows.astype(np.int64),
        cols2d.astype(np.int64), vals2d, vals2d.reshape(-1), x)]
    out, ys = {}, {}
    for label, (fn, n_iters) in formulations(n).items():
        ys[label] = fn(*args)
        ms = ms_per_call(lambda: fn(*args), dev, n_iters)
        rate = E / (ms * 1e-3)
        out[label] = dict(ms=ms, elements_per_s=rate)
        if verbose:
            say(f"{label:30s} {rate:.3e} elems/s  ({ms:.4f} ms, "
                f"{where(dev)})")
    ref = ys["ELL K-gathers"]
    scale = float(ref.abs().max())
    for label in ("ELL 2D gather", "COO gather+segsum", "ELL torch.take"):
        err = float((ys[label] - ref).abs().max()) / scale
        out[label]["rel_err_vs_ell_k"] = err
        if not err < 1e-5:
            raise AssertionError(f"probe_gather: {label} differs from the "
                                 f"K-gather ELL by {err:.2e}")
    return out


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--n", type=int, default=N_DEFAULT)
    args = p.parse_args(argv)
    return run(args.n, device(args))


if __name__ == "__main__":
    main()
