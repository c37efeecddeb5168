"""The gather probes — the twin of scratch/probe_dyngather.py, on kernels
K7 and K8 (`ops/gather_probe.py`, `csrc/gather_probe.cu`).

    python -m gnnla_tpu_torch.scratch.probe_dyngather [--scale S] [--cpu]

Runs the script's five probes: `probe_axis0` at (R = 8, B = 512) and
(R = 512, B = 64), `probe_axis1` with R = 512, B = 256 at 8, 16 and 32
chunks of 128 (B divided by --scale). Each prints its error against
numpy (the kernel must equal it bit for bit, or the probe raises), ms per
launch and gathers per second.
"""

from __future__ import annotations

import numpy as np
import torch

from gnnla_tpu_torch.ops.gather_probe import GatherProbe, axis0_path
from gnnla_tpu_torch.scratch._common import (device, ms_per_call, parser,
                                             say, where)


def axis1_inputs(R: int, n_chunks: int, n_blocks: int):
    """(win, lo, hi, vals, idx) as probe_axis1 draws them (seed 0)."""
    W = n_chunks * 128
    rng = np.random.default_rng(0)
    idx = rng.integers(0, W, size=(n_blocks, R, 128), dtype=np.int32)
    vals = rng.standard_normal((n_blocks, R, 128), dtype=np.float32)
    win = rng.standard_normal((W,), dtype=np.float32)
    return win, idx % 128, idx // 128, vals, idx


def axis0_inputs(R: int, n_blocks: int):
    """(win, idx) as probe_axis0 draws them (seed 0)."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, R, size=(n_blocks, R, 128), dtype=np.int32)
    win = rng.standard_normal((R, 128), dtype=np.float32)
    return win, idx


def _report(name: str, err: float, out: torch.Tensor, ms: float,
            dev: torch.device, verbose: bool, unit: str) -> dict:
    rate = out.numel() / (ms * 1e-3)
    if verbose:
        say(f"{name}: max err {err}")
        say(f"{name}: {rate:.3e} {unit}/s  ({ms:.4f} ms per launch, "
            f"{where(dev)})")
    if err != 0.0:
        raise AssertionError(f"{name}: the kernel differs from numpy by "
                             f"{err}")
    return dict(max_abs_err=err, ms=ms, per_s=rate, elements=out.numel())


def probe_axis1(dev: torch.device, R: int = 512, n_chunks: int = 16,
                n_blocks: int = 256, n_iters: int = 20,
                probe: GatherProbe = None, verbose: bool = True) -> dict:
    """K7 on [n_blocks, R, 128] edges and a window of n_chunks * 128."""
    probe = GatherProbe() if probe is None else probe
    win, lo, hi, vals, idx = axis1_inputs(R, n_chunks, n_blocks)
    args = [torch.from_numpy(a).to(dev) for a in (win, lo, hi, vals)]
    out = probe.axis1(*args)
    err = float(np.abs(out.cpu().numpy() - win[idx] * vals).max())
    ms = ms_per_call(lambda: probe.axis1(*args), dev, n_iters)
    res = _report(f"axis1 W={n_chunks * 128} R={R}", err, out, ms, dev,
                  verbose, "edges")
    return dict(res, args=args, out=out, W=n_chunks * 128)


def probe_axis0(dev: torch.device, R: int = 512, n_blocks: int = 64,
                n_iters: int = 20, probe: GatherProbe = None,
                verbose: bool = True) -> dict:
    """K8 on [n_blocks, R, 128] indices into a window [R, 128]."""
    probe = GatherProbe() if probe is None else probe
    win, idx = axis0_inputs(R, n_blocks)
    args = [torch.from_numpy(a).to(dev) for a in (win, idx)]
    out = probe.axis0(*args)
    expect = win[idx, np.arange(128)[None, None, :]]
    err = float(np.abs(out.cpu().numpy() - expect).max())
    ms = ms_per_call(lambda: probe.axis0(*args), dev, n_iters)
    path = axis0_path(R)
    res = _report(f"axis0 R={R} ({path})", err, out, ms, dev, verbose,
                  "gathers")
    return dict(res, args=args, out=out, path=path)


def main(argv=None) -> list:
    p = parser(__doc__)
    p.add_argument("--scale", type=int, default=1,
                   help="divide every probe's block count by this")
    args = p.parse_args(argv)
    dev = device(args)
    probe = GatherProbe()
    out = [probe_axis0(dev, R=8, n_blocks=512 // args.scale, probe=probe),
           probe_axis0(dev, R=512, n_blocks=64 // args.scale, probe=probe)]
    for nc in (8, 16, 32):
        out.append(probe_axis1(dev, n_chunks=nc,
                               n_blocks=256 // args.scale, probe=probe))
    return out


if __name__ == "__main__":
    main()
