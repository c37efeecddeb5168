"""Kernel K5, the build-and-launch health probe — the counterpart of the
JAX bench's `_pallas_health_probe` (bench.py:148), which doubles one
(8, 128) f32 block to check that the TPU builds and runs a kernel.

  * `HealthCall`   — the wrapper: y = 2 x, kernel K5 (`csrc/health.cu`)
                     on a CUDA tensor (counted in `launches`), the plain
                     version on a CPU tensor.
  * `health_plain` — the plain PyTorch version, 2 * x.
  * `health_cuda`  — the raw launch.
  * `health_probe` — builds (at first use) and launches K5 on ones and
                     requires exactly 2 everywhere; raises otherwise.
"""

from __future__ import annotations

import time

import torch

from gnnla_tpu_torch import _build
from gnnla_tpu_torch._device import resolve_device

SHAPE = (8, 128)  # the TPU probe's one block


def health_plain(x: torch.Tensor) -> torch.Tensor:
    return 2.0 * x


def health_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch K5: y = 2 x for a contiguous f32 tensor on a CUDA device."""
    if x.device.type != "cuda":
        raise ValueError(f"health: x lies on {x.device}, not CUDA")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("health: x must be contiguous float32")
    y = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.check(lib.health_f32(x.data_ptr(), y.data_ptr(), x.numel(),
                                    stream), "health_f32")
    return y


class HealthCall:
    """y = 2 x: K5 on a CUDA tensor (each launch counted in `launches`),
    the plain version on a CPU tensor."""

    def __init__(self):
        self.launches = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return health_plain(x)
        y = health_cuda(x)
        self.launches += 1
        return y


def health_probe(device="cuda", call: HealthCall = None) -> float:
    """Build (at first use) and launch K5 on a block of ones and require
    y == 2 bitwise. Returns the seconds of build, launch and check; raises
    RuntimeError when the result is wrong (and whatever the build or the
    launch raises). `call` is the wrapper to count the launch on."""
    dev = resolve_device(device)
    call = HealthCall() if call is None else call
    t0 = time.perf_counter()
    x = torch.ones(SHAPE, device=dev)
    y = call(x)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if not torch.equal(y, torch.full_like(x, 2.0)):
        raise RuntimeError(f"health probe: y != 2 x on {dev} (max |y - 2| "
                           f"{float((y - 2.0).abs().max())})")
    return time.perf_counter() - t0
