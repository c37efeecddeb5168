"""Time the "stream" leg of the PyTorch port's `AutoTwoGrid` on one
NVIDIA card, with its spread, so two commits can be compared.

    python3 scripts/torch_stream_cycle.py [--tree DIR] [--windows 15]
                                          [--cycles 20]

Builds the operator of chip_smoke.py's stream phase (the 1024^2 FD
Laplacian with its vertices shuffled by default_rng(0)), its CLJP
two-grid setup (theta 0.25, seed 0) and `AutoTwoGrid` on it (layout
"stream": A on kernel K2 in RCM order), then times `--windows` CUDA-event
windows of `--cycles` cycles from x = 0, alternating autograd on (as
chip_smoke.py times the cycle) and off (`torch.no_grad()`). Prints one
JSON line: the tree, the card and its power limit, and per mode the
median, minimum, maximum and every window's ms per cycle.

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
    ap.add_argument("--windows", type=int, default=15)
    ap.add_argument("--cycles", type=int, default=20)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch

    from gnnla_tpu_torch.models.vcycle import AutoTwoGrid, setup_twogrid
    from gnnla_tpu_torch.ops.sparse import SparseOperator
    from gnnla_tpu_torch.problems import laplacian_2d

    if not torch.cuda.is_available():
        print("torch_stream_cycle: needs an NVIDIA card", file=sys.stderr)
        return 2
    gc.disable()  # no collection pause inside a timed window
    dev = torch.device("cuda")
    A = laplacian_2d(1024, device=dev).eliminate_zeros()
    rows, cols, vals = A.host_coo()
    new = np.argsort(np.random.default_rng(0).permutation(A.n_rows))
    A_p = SparseOperator.from_coo(new[rows], new[cols], vals, A.shape,
                                  device=dev)
    auto = AutoTwoGrid(setup_twogrid(A_p, theta=0.25, splitting="cljp",
                                     seed=0))
    if auto.layout != "stream":
        raise AssertionError((auto.layout, auto.why))
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(
        A.n_rows).astype(np.float32)).to(dev)
    x0 = torch.zeros_like(b)

    def window() -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.cycles):
            auto.run(b, x0)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.cycles

    for _ in range(3):
        auto.run(b, x0)
    torch.cuda.synchronize()
    ms = {"grad_on": [], "no_grad": []}
    for _ in range(args.windows):
        ms["grad_on"].append(window())
        with torch.no_grad():
            ms["no_grad"].append(window())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(dict(
        tree=tree, nvidia_smi=smi, cycles_per_window=args.cycles,
        **{mode: dict(median=float(np.median(v)), min=min(v), max=max(v),
                      windows=v) for mode, v in ms.items()})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
