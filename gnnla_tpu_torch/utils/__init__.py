"""Timing, throughput counters, metrics logging and tracing; the kernel
build's health probe (kernel K5)."""

from gnnla_tpu_torch.utils.health import health_probe
from gnnla_tpu_torch.utils.metrics import (MetricsLogger, Timer,
                                           edges_per_second, profile_trace)

__all__ = ["Timer", "edges_per_second", "MetricsLogger", "profile_trace",
           "health_probe"]
