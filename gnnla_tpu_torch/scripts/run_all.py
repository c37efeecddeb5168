"""The five artifact pipelines at their defaults, in the JAX order, one
process each: reproduce_jacobi, reproduce_jacobi_stable (warm-started from
the first's params.npz), smoother_twogrid (on both), grid_diffusion,
reproduce_diffusion.

    python -m gnnla_tpu_torch.scripts.run_all --log-dir DIR [--device cpu]

Each twin's output goes to DIR/<name>.log; its printed results line (the
last) is written verbatim to DIR/artifacts_torch/{jacobi,diffusion}/<the
JAX artifact's file name>. Stops at the first twin that fails. Prints one
JSON line: each twin's wall seconds and the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from gnnla_tpu_torch._device import resolve_device
from gnnla_tpu_torch.scripts._common import device_line

# (module, results file under artifacts_torch/), in the JAX order
PIPELINES = (
    ("reproduce_jacobi", "jacobi/results.json"),
    ("reproduce_jacobi_stable", "jacobi/results_stable.json"),
    ("smoother_twogrid", "jacobi/smoother_twogrid.json"),
    ("grid_diffusion", "diffusion/grid.json"),
    ("reproduce_diffusion", "diffusion/results.json"),
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gnnla_tpu_torch.scripts.run_all")
    p.add_argument("--log-dir", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    dev_line = device_line(resolve_device(args.device))
    seconds = {}
    for name, rel in PIPELINES:
        log = os.path.join(args.log_dir, f"{name}.log")
        os.makedirs(args.log_dir, exist_ok=True)
        t0 = time.perf_counter()
        with open(log, "w") as f:
            rc = subprocess.run(
                [sys.executable, "-m", f"gnnla_tpu_torch.scripts.{name}",
                 "--device", args.device], stdout=f,
                stderr=subprocess.STDOUT).returncode
        seconds[name] = time.perf_counter() - t0
        if rc:
            print(f"{name} failed (rc {rc}); see {log}", file=sys.stderr)
            return rc
        with open(log) as f:
            last = f.read().rstrip("\n").splitlines()[-1]
        json.loads(last)  # the results line
        out = os.path.join(args.log_dir, "artifacts_torch", rel)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            f.write(last + "\n")
    print(json.dumps({"seconds": seconds, "device": dev_line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
