"""The profiler reader: device busy and idle time, device time by kernel
name, and idle gaps by what the host was doing.

After `gnnla_tpu_torch/bench.py::device_ms` and `chip_smoke.py::
profile_cycles` (the throwaway first profile, the CUDA-side events as the
device's work), but from the timeline rather than from `key_averages`:
busy time is the union of the device's intervals, so work on two streams
is never counted twice, and each idle gap between them is named by the
harness span and the innermost host operation running at its middle.

The harness marks its own steps with `span(name)` (a `record_function`
named "perfbench.<name>"); they cost nothing that matters when no
profiler runs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "perfbench."
WINDOW = PREFIX + "window"
TOP = 10           # entries in each list of the breakdown
NAME_CHARS = 160   # a kernel's name in the breakdown, cut to this


def span(name: str):
    """A harness span around a call into the program."""
    return torch.profiler.record_function(PREFIX + name)


@dataclasses.dataclass
class TraceSummary:
    """One traced segment: its length, the device's busy seconds in it,
    device seconds and launches by kernel name, idle seconds by the host's
    activity, and the host's calls by name."""

    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]]
    idle: Dict[str, float]
    host_calls: Dict[str, int]

    def seconds_matching(self, needles, exclude=()) -> float:
        """Device seconds of the kernels whose name holds one of `needles`
        and none of `exclude` (case-insensitive)."""
        total = 0.0
        for name, (s, _) in self.kernels.items():
            low = name.lower()
            if any(n in low for n in needles) and \
                    not any(e in low for e in exclude):
                total += s
        return total

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k[:NAME_CHARS], v[0]] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _is_device(ev) -> bool:
    return ev.device_type == torch.autograd.DeviceType.CUDA


def _merge(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events) -> Optional[TraceSummary]:
    """The segment inside the harness's window span, from the profiler's
    events (`prof.events()`: times in microseconds on one clock); None
    when the events hold no window span."""
    windows = [ev for ev in events
               if not _is_device(ev) and ev.name == WINDOW]
    if not windows:
        return None
    win = windows[0]
    w0, w1 = win.time_range.start, win.time_range.end
    kernels: Dict[str, List] = {}
    intervals = []
    host = []
    for ev in events:
        s, e = ev.time_range.start, ev.time_range.end
        if _is_device(ev):
            # a record_function also leaves an annotation on the device's
            # timeline: a span, not work
            if ev.name.startswith(PREFIX) or \
                    getattr(ev, "is_user_annotation", False):
                continue
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            intervals.append((s, e))
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += (e - s) * 1e-6
            k[1] += 1
        elif e > w0 and s < w1 and ev is not win:
            host.append((s, e, ev.name))
    calls: Dict[str, int] = {}
    for _, _, name in host:
        calls[name] = calls.get(name, 0) + 1
    busy = _merge(intervals)
    gaps, cur = [], w0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if w1 > cur:
        gaps.append((cur, w1))
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(e - s for s, e in busy) * 1e-6,
        kernels={k: (v[0], v[1]) for k, v in kernels.items()},
        idle=_label_gaps(gaps, host),
        host_calls=calls)


def _label_gaps(gaps, host) -> Dict[str, float]:
    """Seconds of idle gaps by label: the innermost harness span and the
    innermost other host operation (the latest begun) open at each gap's
    middle."""
    host.sort(key=lambda h: (h[0], -h[1]))
    out: Dict[str, float] = {}
    stack: List[Tuple[float, float, str]] = []
    j = 0
    for g0, g1 in sorted(gaps):
        mid = 0.5 * (g0 + g1)
        while j < len(host) and host[j][0] <= mid:
            stack.append(host[j])
            j += 1
        stack = [h for h in stack if h[1] >= mid]
        spans = [h[2][len(PREFIX):] for h in stack
                 if h[2].startswith(PREFIX)]
        ops = [h[2] for h in stack if not h[2].startswith(PREFIX)]
        label = " > ".join(([spans[-1]] if spans else ["host"])
                           + ([ops[-1]] if ops else []))
        out[label] = out.get(label, 0.0) + (g1 - g0) * 1e-6
    return out


def profile_items(step: Callable[[int], None], n_items: int,
                  device: torch.device, counters: Callable[[], dict]):
    """Run step(j) for j < n_items under the profiler, after a throwaway
    profile of two items (the first profile of a process starts the
    tracer). Returns the segment's summary and what `counters()` moved
    over it."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    for n in (2, n_items):
        before = counters()
        with profile(activities=acts) as prof:
            with span("window"):
                for j in range(n):
                    step(j)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
        after = counters()
    moved = {k: v - before.get(k, 0) for k, v in after.items()}
    return summarize(prof.events()), moved
