"""Whole cycles and solves as one captured CUDA graph — the port's twin of
`jax.jit` over a function (and of the `lax.scan` inside one).

    run = program(fn)
    y = run(*args, **kwargs)

The JAX package never runs a cycle op by op on its chip: each entry point
(`StencilVCycle.run`, `GeometricVCycle.run`, `AutoTwoGrid.run`/`.solve`,
the bench's scans) is one XLA program. Eagerly the port would enqueue each
PyTorch op and each kernel from the host, and a cycle of small ops then
waits on the host. A program captures one call into a
`torch.cuda.CUDAGraph` and replays it, so the whole cycle or solve is one
launch from the host.

Arguments. Positional tensor arguments are the program's inputs; every
other argument (setup objects, operators, Python scalars, keyword
arguments) is static. The cache key is the static arguments' identity
(their value for None, bools, numbers, strings, dtypes, devices and tuples
of those) and the inputs' shape, dtype and device; a new key captures
anew, as a jit retraces on new static arguments. The JAX package passes
setup arrays as jit arguments, so a new setup of the same structure reuses
its executable; here a new setup object costs one capture. A graph reads
the static arguments' tensors where they lay at capture: their values may
change in place, but a tensor replaced by another needs a new setup
object (a kernel layout derived from data is covered by a guard, below).
`fn` must write into none of its tensor inputs, as a JAX function cannot.

On a CUDA device the first call with a key runs `fn` once on a side
stream (the warm-up PyTorch's graph documentation requires; the kernel
library builds there and the kernels' one-time attributes are set) and
returns that result, then captures one call under `torch.no_grad()`. Each
later call copies its inputs into the graph's input buffers, replays, and
returns a clone of the graph's output, so no two calls alias. Inside a
capture that is already running (or inside another program's warm-up) a
program calls `fn` directly, so programs nest. On a CPU device a program
is `fn` itself (the JAX package on the CPU); the device is the inputs'
own. A capture that fails raises (it never runs the call eagerly
instead), and an input that requires grad is refused on the card: the
training steps are not programs yet.

Counters. The kernel wrappers count their launches through `count`. The
warm-up counts as an eager call does; a capture records what it would
have counted and moves nothing; each replay adds the recorded counts. So
after N calls every counter reads what N eager calls give.

Guards. A wrapper whose layout derives from its data (kernel K1's compact
tiles of the diagonals) registers a guard while it is captured (`guard`):
a function that reads the layout's key and the key it was built for.
Before each replay every guard is read; on a mismatch the program warms
up again, which rebuilds the layout as an eager call would (and counts it
in the wrapper's `rebuilds`), and captures anew. A stale layout is never
replayed.

Spans. `span(name)` marks a part of the hot path (a solve, a cycle, a
level, a program's host steps, K1's enqueue); it is on only while a torch
profiler records (`torch.autograd.profiler._is_profiler_enabled`), and
off it costs one flag test and allocates nothing. On, outside a capture,
a span is a profiler range "gnnla.<name>" (the fast form of
`record_function`) and a host-clock pair; inside a capture it records a
pair of timing events on the capture stream, which become event nodes of
the graph. A traced replay reads their elapsed times while the graph
runs, each span as soon as its end event has completed (the span
`program.collect`), and returns when the replay has finished. A host-only
span (`span_begin(name, host_only=True)`) records nothing inside a
capture. `stage(name)` marks a set-up step: it is always timed by the
host clock, and is a profiler range too while one records. Both add into
one registry in memory, keyed by name: calls and host seconds, device
calls, device seconds and self device seconds (less the child spans),
and the parent span's name; `report()` reads it and `reset()` empties
it. The `gnnla.*` ranges reach a Chrome trace through any
`torch.profiler` run (`utils/metrics.profile_trace`).

The cache key holds whether a profiler records. While none does a program
replays its plain graph, which holds no event node; its first call while
one records warms up and captures an instrumented graph once (counted in
`captures`), and later calls while none records replay the plain graph
again, with no capture.
"""

from __future__ import annotations

import contextlib
import contextvars
import gc
from time import perf_counter
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

# the capture running in this context, None outside one; and whether a
# program's warm-up or capture is running (a program inside one is its fn)
_CAPTURE: contextvars.ContextVar = contextvars.ContextVar(
    "gnnla_program_capture", default=None)
_INSIDE: contextvars.ContextVar = contextvars.ContextVar(
    "gnnla_program_inside", default=False)
_VALUE_TYPES = (type(None), bool, int, float, complex, str, torch.dtype,
                torch.device)

PREFIX = "gnnla."  # the spans' and stages' names in a profiler's trace
# the names of the host spans and stages open in this context, innermost last
_OPEN: contextvars.ContextVar = contextvars.ContextVar(
    "gnnla_open_spans", default=())
# name -> [calls, host s, device calls, device s, self device s, parent]
_STATS: Dict[str, list] = {}
_OFF = contextlib.nullcontext()
# a profiler range without the dispatcher's op call: ~1.5 us a span under
# a profiler, where `record_function` takes ~13 us
_RANGE = torch._C._profiler._RecordFunctionFast


class _Record:
    """What one capture records: the counters' increments (by object and
    attribute), the guards (read function -> key at capture), and the
    device spans ([name, index of the parent span or -1, start event, end
    event], in the order they opened; `closed` their indices in the order
    they closed)."""

    def __init__(self):
        self.counts: Dict[Tuple[int, str], list] = {}
        self.guards: Dict[Callable[[], Any], Any] = {}
        self.spans: List[list] = []
        self.open: List[int] = []
        self.closed: List[int] = []

    def apply(self) -> None:
        for obj, attr, k in self.counts.values():
            setattr(obj, attr, getattr(obj, attr) + k)

    def holds(self) -> bool:
        return all(read() == key for read, key in self.guards.items())


def count(obj, attr: str, k: int = 1) -> None:
    """Add k to `obj.attr` for k kernel launches; inside a capture, record
    the k for every replay of the graph instead."""
    rec = _CAPTURE.get()
    if rec is None:
        setattr(obj, attr, getattr(obj, attr) + k)
        return
    entry = rec.counts.setdefault((id(obj), attr), [obj, attr, 0])
    entry[2] += k


def guard(read: Callable[[], Any], key) -> None:
    """Inside a capture, make each replay check that `read()` still gives
    `key` (and capture anew where it does not); outside one, nothing.
    `read` is hashable (a bound method): one guard per read function."""
    rec = _CAPTURE.get()
    if rec is not None:
        rec.guards.setdefault(read, key)


def _stat(name: str, parent: Optional[str]) -> list:
    entry = _STATS.get(name)
    if entry is None:
        entry = _STATS[name] = [0, 0.0, 0, 0.0, 0.0, parent]
    entry[5] = parent
    return entry


def span_begin(name: str, host_only: bool = False):
    """Open span `name`, for a caller that has found a profiler recording
    (`torch.autograd.profiler._is_profiler_enabled`): the form of `span`
    with no context-manager object. Returns what `span_end` closes; inside
    a capture a device span records its start event there, and a
    host-only span records nothing (None)."""
    rec = _CAPTURE.get()
    if rec is not None:
        if host_only:
            return None
        start = torch.cuda.Event(enable_timing=True, external=True)
        start.record()
        rec.spans.append([name, rec.open[-1] if rec.open else -1, start,
                          None])
        rec.open.append(len(rec.spans) - 1)
        return rec
    return _host_begin(name, True)


def span_end(state) -> None:
    """Close what `span_begin` opened; nothing for None."""
    if state is None:
        return
    if isinstance(state, _Record):
        end = torch.cuda.Event(enable_timing=True, external=True)
        end.record()
        i = state.open.pop()
        state.spans[i][3] = end
        state.closed.append(i)
        return
    _host_end(state)


def _host_begin(name: str, traced: bool):
    outer = _OPEN.get()
    token = _OPEN.set(outer + (name,))
    rf = None
    if traced:
        rf = _RANGE(PREFIX + name)
        rf.__enter__()
    return name, outer[-1] if outer else None, token, rf, perf_counter()


def _host_end(state) -> None:
    name, parent, token, rf, t0 = state
    dt = perf_counter() - t0
    if rf is not None:
        rf.__exit__(None, None, None)
    _OPEN.reset(token)
    entry = _stat(name, parent)
    entry[0] += 1
    entry[1] += dt


class _Span:
    __slots__ = ("name", "state")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.state = span_begin(self.name)

    def __exit__(self, *exc):
        span_end(self.state)


def span(name: str, index: Optional[int] = None):
    """A span of the hot path (see the module doc), named `name`, or
    `name` followed by `index`: a context manager, the shared null one
    while no profiler records."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name if index is None else f"{name}{index}")


@contextlib.contextmanager
def stage(name: str):
    """A set-up step, timed by the host clock into the registry (and a
    profiler range while a profiler records). Never on a per-solve or
    per-apply path."""
    state = _host_begin(name, _profiler._is_profiler_enabled)
    try:
        yield
    finally:
        _host_end(state)


def _read(rec: _Record) -> None:
    """Add a replay's device spans to the registry: the elapsed time of
    each, read as soon as its end event has completed (in the order the
    spans closed, so the reading overlaps the replay), and its self time
    (less its children's)."""
    ms = [0.0] * len(rec.spans)
    for i in rec.closed:
        _, _, start, end = rec.spans[i]
        end.synchronize()
        ms[i] = start.elapsed_time(end)
    inner = [0.0] * len(ms)
    for (_, parent, _, _), t in zip(rec.spans, ms):
        if parent >= 0:
            inner[parent] += t
    for (name, parent, _, _), t, t_in in zip(rec.spans, ms, inner):
        entry = _stat(name, rec.spans[parent][0] if parent >= 0 else None)
        entry[2] += 1
        entry[3] += 1e-3 * t
        entry[4] += 1e-3 * (t - t_in)


def report() -> Dict[str, dict]:
    """The registry: for each span or stage name, `calls` and `host_s`
    (host clock, outside captures), `device_calls`, `device_s` and
    `self_device_s` (a graph's replays), and `parent` (the enclosing
    span's name, as last seen)."""
    keys = ("calls", "host_s", "device_calls", "device_s", "self_device_s",
            "parent")
    return {name: dict(zip(keys, entry)) for name, entry in _STATS.items()}


def reset() -> None:
    """Empty the registry."""
    _STATS.clear()


@contextlib.contextmanager
def _recording(record: _Record):
    """Count into `record` and run nested programs as their functions,
    for the duration of a capture."""
    tokens = _CAPTURE.set(record), _INSIDE.set(True)
    try:
        yield record
    finally:
        _CAPTURE.reset(tokens[0])
        _INSIDE.reset(tokens[1])


@contextlib.contextmanager
def _gc_paused():
    """Python's cyclic garbage collector off for the duration (then as it
    was). A collection inside a capture can free another program's graph
    (one held in a reference cycle, as `StencilVCycle` and its program
    are), and destroying a graph while a stream captures invalidates the
    capture."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _static_key(a):
    if isinstance(a, _VALUE_TYPES):
        return (type(a), a)
    if type(a) in (tuple, list):
        return (type(a), tuple(_static_key(v) for v in a))
    return ("id", id(a))


def _tensors(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for v in out for t in _tensors(v)]
    return []


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (tuple, list)):
        return type(out)(_clone(v) for v in out)
    return out


class _Graph:
    """One captured call: the graph, its input buffers, its output, what
    the capture recorded, and the static arguments it was captured for
    (held, so that their identities stay theirs)."""

    def __init__(self, graph, inputs, out, record, statics):
        self.graph = graph
        self.inputs = inputs
        self.out = out
        self.record = record
        self.statics = statics

    def replay(self, tensors):
        for buf, t in zip(self.inputs, tensors):
            buf.copy_(t)
        self.graph.replay()
        self.record.apply()
        return _clone(self.out)

    def replay_traced(self, tensors):
        """`replay` with each host step a span, and the replay's device
        spans read as it runs (it has finished on return)."""
        with _Span("program.inputs"):
            for buf, t in zip(self.inputs, tensors):
                buf.copy_(t)
        with _Span("program.launch"):
            self.graph.replay()
        with _Span("program.outputs"):
            self.record.apply()
            out = _clone(self.out)
        if self.record.spans:
            with _Span("program.collect"):
                _read(self.record)
        return out


class Program:
    """`fn` as a program (see the module doc). `captures` counts every
    capture: a new key's, a recapture after a guard's mismatch, and the
    instrumented graph of the first call while a profiler records (the
    key holds that flag); `replays` counts the replays. The call that
    captures returns the result of its warm-up: so does the first call
    with a key, and so does the first traced call."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self._graphs: Dict[tuple, _Graph] = {}
        self.captures = 0
        self.replays = 0

    def __call__(self, *args, **kwargs):
        idx = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        if not idx:
            raise ValueError("a program takes at least one positional "
                             "tensor input")
        devs = {args[i].device for i in idx}
        if len(devs) > 1:
            raise ValueError(f"a program's inputs lie on one device, not "
                             f"{sorted(str(d) for d in devs)}")
        dev = devs.pop()
        if dev.type != "cuda":
            return self.fn(*args, **kwargs)
        with torch.cuda.device(dev):
            if _INSIDE.get() or torch.cuda.is_current_stream_capturing():
                return self.fn(*args, **kwargs)
            if any(args[i].requires_grad for i in idx):
                raise NotImplementedError(
                    "a program runs without autograd: an input requires "
                    "grad; the trainers' jitted steps are programs of a "
                    "later slice of the port")
            traced = _profiler._is_profiler_enabled
            state = span_begin("program.lookup") if traced else None
            try:
                key = (traced,
                       tuple((a.shape, a.dtype, a.device) if i in idx
                             else _static_key(a)
                             for i, a in enumerate(args)),
                       tuple(sorted((k, _static_key(v))
                                    for k, v in kwargs.items())))
                g = self._graphs.get(key)
                hit = g is not None and g.record.holds()
            finally:
                span_end(state)
            if hit:
                self.replays += 1
                tensors = [args[i] for i in idx]
                return (g.replay_traced(tensors) if traced
                        else g.replay(tensors))
            out = self._warm_up(dev, args, kwargs)
            self._graphs[key] = self._capture(args, kwargs, idx)
            return out

    @stage("program.warmup")
    def _warm_up(self, dev, args, kwargs):
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        token = _INSIDE.set(True)
        try:
            with torch.cuda.stream(side), torch.no_grad():
                out = self.fn(*args, **kwargs)
        finally:
            _INSIDE.reset(token)
        cur.wait_stream(side)
        for t in _tensors(out):
            t.record_stream(cur)
        return out

    @stage("program.capture")
    def _capture(self, args, kwargs, idx) -> _Graph:
        inputs = [args[i].detach().clone() for i in idx]
        call = list(args)
        for i, buf in zip(idx, inputs):
            call[i] = buf
        graph = torch.cuda.CUDAGraph()
        record = _Record()
        with _gc_paused(), _recording(record), torch.no_grad(), \
                torch.cuda.graph(graph):
            out = self.fn(*call, **kwargs)
        self.captures += 1
        statics = ([a for i, a in enumerate(args) if i not in idx],
                   dict(kwargs))
        return _Graph(graph, inputs, out, record, statics)


def program(fn: Callable) -> Program:
    """`fn` as a program: the twin of `jax.jit(fn)` (see the module doc)."""
    return Program(fn)
