"""Throughput counters and timing — the PyTorch counterpart of
gnnla_tpu/utils/metrics.py.

`edges_per_second` is the headline throughput counter; `Timer` is a
minimal wall-clock context that waits for the device's queued work
before it stops, so asynchronous CUDA launches can't fake the numbers.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import torch

from gnnla_tpu_torch._device import resolve_device


def _device_of(device: Union[str, torch.device, torch.Tensor]
               ) -> torch.device:
    if isinstance(device, torch.Tensor):
        return device.device
    return resolve_device(device)


@dataclass
class Timer:
    """Wall-clock timer that waits for `device`'s work before stopping.

    `device` is a device (default the card; raises without one unless
    "cpu" is given) or a tensor, whose device is taken. On a CUDA device
    the exit calls torch.cuda.synchronize(device), the counterpart of
    the JAX package's jax.effects_barrier()."""

    device: Union[str, torch.device, torch.Tensor] = "cuda"
    elapsed_s: float = 0.0
    _t0: Optional[float] = None

    def __post_init__(self):
        self.device = _device_of(self.device)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.elapsed_s = time.perf_counter() - self._t0
        return False


def edges_per_second(nnz: int, n_applications: int, seconds: float) -> float:
    """Message-passing throughput: edges (nonzeros) processed per second."""
    return nnz * n_applications / max(seconds, 1e-12)


@dataclass
class MetricsLogger:
    """Append-only JSONL metrics sink, one record per `log` call with the
    keys step, time and the metrics given."""

    path: Optional[str] = None
    history: List[Dict] = field(default_factory=list)

    def log(self, step: int, **metrics) -> None:
        rec = {"step": step, "time": time.time(), **metrics}
        self.history.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")


@contextlib.contextmanager
def profile_trace(log_dir: str,
                  device: Union[str, torch.device, torch.Tensor] = "cuda"):
    """torch.profiler trace context: host activity, and the card's when
    `device` is CUDA; on exit a Chrome trace (`*.pt.trace.json`, for
    TensorBoard or chrome://tracing) is written under `log_dir`. Yields
    the profiler."""
    dev = _device_of(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof
