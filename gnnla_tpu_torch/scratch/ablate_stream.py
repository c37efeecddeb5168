"""K2's time split by stage — the twin of scratch/ablate_stream.py, on
kernel K9 (`ops/stream_ablate.py`, `csrc/csr_ablate.cu`).

    python -m gnnla_tpu_torch.scratch.ablate_stream [VARIANT ...] [--n N]
                                                    [--cpu]

The fixture: the Delaunay Laplacian of N points (default 1,048,576;
numpy seed 7) built as scratch/proto_ellw.py builds it, scaled by
1 / (2 max diag) and put in reverse Cuthill-McKee order, as the script
does (:19-22). (The script calls a `delaunay_laplacian` that nothing
defines; the twin takes proto_ellw.py's.) Every variant (default: all
six) is held against its plain version, bit for bit, and `full` against
K2 on the same CSR and row blocks; then each is timed with the L2 cache
flushed and warm, and the stage costs are taken by difference from full.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gnnla_tpu_torch.ops.stream_ablate import VARIANTS, StreamAblation
from gnnla_tpu_torch.ops.stream_spmv import CsrSpMV, rcm_csr
from gnnla_tpu_torch.scratch._common import (device, ms_per_call, parser,
                                             say, where)
from gnnla_tpu_torch.scratch.proto_ellw import delaunay_laplacian

N_DEFAULT = 1 << 20
# the stage each variant drops, for the differences from full
DROPPED = {"nomatmul": "matmul (no counterpart)", "nogather": "gather",
           "noscan": "scan", "nodeposit": "deposit",
           "minimal": "gather + deposit + scan"}


def fixture(lap):
    """The ablation's operator from a Delaunay Laplacian (natural order):
    ablate_stream.py:20-22."""
    lap = (lap / (lap.diagonal().max() * 2.0)).tocsr()
    lap.sort_indices()
    A, _ = rcm_csr(lap)
    return A


def run(A, dev: torch.device, variants=VARIANTS, *, iters: int = 20,
        flush: torch.Tensor = None, verbose: bool = True) -> dict:
    """Each variant on the CSR A: its launch against its plain version
    (bitwise), `full` against K2; ms per launch with the L2 flushed
    (`flush`, on the card) and warm; stage costs as differences from
    full. Launches per variant: 1 + (1 + iters) warm + (1 + iters)
    flushed on the card, 1 + (1 + iters) on the host."""
    t0 = time.perf_counter()
    k2 = CsrSpMV(A, device=dev)
    abl = StreamAblation(k2)
    if verbose:
        say(f"rows={A.shape[0]} nnz={A.nnz} row_blocks="
            f"{k2.row_blocks.shape[0] - 1} build "
            f"{time.perf_counter() - t0:.1f}s (device {dev})")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        A.shape[1]).astype(np.float32)).to(dev)
    y_k2 = k2(x)
    out = dict(k2=k2, ablation=abl, x=x, variants={})
    for v in variants:
        y = abl(v, x)
        plain = abl.plain(v, x)
        bitwise = bool(torch.equal(y, plain))
        if not bitwise:
            raise AssertionError(f"ablate_stream: {v} differs from its plain "
                                 f"version by {float((y - plain).abs().max())}")
        if v == "full" and not torch.equal(y, y_k2):
            raise AssertionError("ablate_stream: full differs from K2")
        warm = ms_per_call(lambda: abl(v, x), dev, iters)
        cold = (ms_per_call(lambda: abl(v, x), dev, iters, flush=flush)
                if flush is not None else None)
        out["variants"][v] = dict(ms_warm=warm, ms_flushed=cold,
                                  edges_per_s=A.nnz / (warm * 1e-3),
                                  bitwise_plain=bitwise)
        if verbose:
            cold_s = f", {cold:.4f} flushed" if cold is not None else ""
            say(f"{v:10s} {A.nnz / (warm * 1e-3):.3e} e/s  {warm:.4f} ms "
                f"warm{cold_s} ({where(dev)})")
    full = out["variants"].get("full")
    if full is not None:
        for v, r in out["variants"].items():
            if v == "full":
                continue
            r["stage_ms_warm"] = full["ms_warm"] - r["ms_warm"]
            if r["ms_flushed"] is not None:
                r["stage_ms_flushed"] = full["ms_flushed"] - r["ms_flushed"]
            if verbose:
                say(f"  {DROPPED[v]:24s} costs {r['stage_ms_warm']:+.4f} ms "
                    "warm" + (f", {r['stage_ms_flushed']:+.4f} flushed"
                              if "stage_ms_flushed" in r else ""))
    return out


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("variants", nargs="*", metavar="VARIANT",
                   help=f"any of {', '.join(VARIANTS)} (default: all)")
    p.add_argument("--n", type=int, default=N_DEFAULT)
    args = p.parse_args(argv)
    unknown = sorted(set(args.variants) - set(VARIANTS))
    if unknown:
        p.error(f"unknown variants {unknown}; choose from {VARIANTS}")
    dev = device(args)
    t0 = time.perf_counter()
    A = fixture(delaunay_laplacian(args.n, np.random.default_rng(7)))
    say(f"fixture {time.perf_counter() - t0:.1f}s")
    flush = (torch.ones(64 * 2 ** 20, device=dev) if dev.type == "cuda"
             else None)
    return run(A, dev, args.variants or VARIANTS, flush=flush)


if __name__ == "__main__":
    main()
