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
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Dict, List, Tuple

import torch

# the capture running in this context, None outside one; and whether a
# program's warm-up or capture is running (a program inside one is its fn)
_CAPTURE: contextvars.ContextVar = contextvars.ContextVar(
    "gnnla_program_capture", default=None)
_INSIDE: contextvars.ContextVar = contextvars.ContextVar(
    "gnnla_program_inside", default=False)
_VALUE_TYPES = (type(None), bool, int, float, complex, str, torch.dtype,
                torch.device)


class _Record:
    """What one capture records: the counters' increments (by object and
    attribute) and the guards (read function -> key at capture)."""

    def __init__(self):
        self.counts: Dict[Tuple[int, str], list] = {}
        self.guards: Dict[Callable[[], Any], Any] = {}

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


class Program:
    """`fn` as a program (see the module doc). `captures` counts the
    captures made, recaptures included, and `replays` the replays."""

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
            key = (tuple((a.shape, a.dtype, a.device) if i in idx
                         else _static_key(a) for i, a in enumerate(args)),
                   tuple(sorted((k, _static_key(v))
                                for k, v in kwargs.items())))
            g = self._graphs.get(key)
            if g is not None and g.record.holds():
                self.replays += 1
                return g.replay([args[i] for i in idx])
            out = self._warm_up(dev, args, kwargs)
            self._graphs[key] = self._capture(args, kwargs, idx)
            return out

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

    def _capture(self, args, kwargs, idx) -> _Graph:
        inputs = [args[i].detach().clone() for i in idx]
        call = list(args)
        for i, buf in zip(idx, inputs):
            call[i] = buf
        graph = torch.cuda.CUDAGraph()
        record = _Record()
        with _recording(record), torch.no_grad(), torch.cuda.graph(graph):
            out = self.fn(*call, **kwargs)
        self.captures += 1
        statics = ([a for i, a in enumerate(args) if i not in idx],
                   dict(kwargs))
        return _Graph(graph, inputs, out, record, statics)


def program(fn: Callable) -> Program:
    """`fn` as a program: the twin of `jax.jit(fn)` (see the module doc)."""
    return Program(fn)
