"""What the scratch twins share: the command line, the device and the
clocks."""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Optional

import torch

from gnnla_tpu_torch._device import resolve_device


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    p.add_argument("--cpu", action="store_true",
                   help="run the plain PyTorch versions on the host")
    return p


def device(args) -> torch.device:
    return resolve_device("cpu" if args.cpu else "cuda")


def say(msg: str) -> None:
    """One line on stderr, where the JAX scripts print."""
    print(msg, file=sys.stderr, flush=True)


def where(dev: torch.device) -> str:
    """The device a number was taken on, for every printed rate."""
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "host CPU, plain version"


def ms_per_call(fn: Callable[[], object], dev: torch.device, iters: int,
                flush: Optional[torch.Tensor] = None) -> float:
    """Mean ms of one call: CUDA events on the card (the L2 cache flushed
    before each call when `flush` is given, a buffer larger than L2), the
    host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(dev)
    if flush is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    total = 0.0
    for _ in range(iters):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
