"""The general generator: what a traffic mix's parameters make from the
run's seed. A mix is a data file (`traffic/<name>.json`); this code reads
it, and the driver its "loop" names runs what it made."""

from __future__ import annotations

import math

import numpy as np
import torch


def host_rng(seed: int) -> np.random.Generator:
    """The run's host generator: any whole number, of any size or sign."""
    return np.random.default_rng(int(seed) % 2 ** 64)


def device_seed(seed: int) -> int:
    """The seed of the run's device generator (torch takes 64 bits)."""
    return int(seed) % 2 ** 63


def rhs_pool(run, n: int) -> torch.Tensor:
    """[P, n] float32 vectors from the seed, made on the device in one
    call: at least `pool_min` of them, and at least `pool_bytes` (more
    than the L2 cache)."""
    tr = run.traffic
    p = max(int(tr["pool_min"]), math.ceil(tr["pool_bytes"] / (4 * n)))
    g = torch.Generator(device=run.device)
    g.manual_seed(device_seed(run.seed))
    return torch.randn((p, n), generator=g, device=run.device,
                       dtype=torch.float32)


def sampler(run, est_items: float, pool: int):
    """(spacing, phase) of the sampled items: every spacing-th item from
    a phase drawn from the seed, about `samples` of them in a window that
    holds `est_items`. The spacing is prime to the pool's length, so the
    samples take distinct vectors of the pool."""
    k = int(run.traffic["samples"])
    spacing = max(1, int(est_items // k))
    while spacing > 1 and math.gcd(spacing, pool) != 1:
        spacing -= 1
    return spacing, int(host_rng(run.seed).integers(spacing))
