"""The port's tracer: named host spans, counters and the count of the
host's synchronizing CUDA operations, in one registry, and the trainers'
synchronized laps (`Clock`).

`counters` is a plain dict of ints, and `physics.kernels.launches` is
the same object: its kernel keys (`fk`, `chol_factor`, ...,
`linesearch_cost`) count launches whether the tracer is on or off.
Every other key holds a dot and a layer prefix, so none can clash with
a kernel's name:

* ``span.<name>.ns``, ``.self_ns``, ``.n``, ``.syncs``: host
  nanoseconds inside the span, the same less its child spans, times
  entered, and synchronizing CUDA operations made while it was open;
* what `count` is given (``newton.*``).

A reader that takes the difference of every key over a window (the
benchmark does so over `kernels.launches`) gets the window's totals of
all of them.

Off is the default, and costs one flag check at each span and counter
site: `span` returns one shared no-op context, `count` returns at
once.  `enable()` turns the tracer on for the whole process.

Spans do not synchronize the device: a span's time is what the host
spends issuing its stage, which is what sets the pace while the device
waits on the host.  Each open span is also a profiler range (a
`torch.profiler` record function named as the span), so in a kineto
trace every device operation lies inside the span that issued it.

While the tracer is on and CUDA is there, PyTorch's sync debug mode
("warn") reports each synchronizing CUDA operation: `.item()`, `bool()`
of a tensor, a copy from pageable host memory to the device.  The
tracer takes those warnings, counts them into every open span, and
prints none.  It adds one warning filter and wraps `warnings.showwarning`
while on; `enable(False)` takes out that filter and restores the mode
and, where no one has replaced the wrapper since, `showwarning`.  PyTorch
calls the mode a prototype that does not see every synchronizing
operation; on the card it reports each of the kinds above, once a call,
and not `torch.cuda.synchronize()`.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from typing import Dict, List, Optional

import torch

counters: Dict[str, int] = {}

_on = False
_stack: List["_Span"] = []
_saved: Optional[tuple] = None     # what `_watch_syncs` put in
SYNC_WARNING = "called a synchronizing CUDA operation"
# A record function of scope FUNCTION: no device-side annotation in a
# kineto trace, and next to nothing while no profiler runs.
_range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)


def enabled() -> bool:
    return _on


def enable(on: bool = True) -> None:
    """Turn the tracer on (or off) for the whole process."""
    global _on
    on = bool(on)
    if on != _on:
        _on = on
        _watch_syncs(on)


def _add(key: str, n: int) -> None:
    counters[key] = counters.get(key, 0) + n


def count(name: str, n: int = 1) -> None:
    """counters[name] += n while the tracer is on."""
    if _on:
        _add(name, n)


_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("key", "range", "t0", "child")

    def __init__(self, name: str):
        self.key = "span." + name
        self.range = _range(name)

    def __enter__(self):
        self.child = 0
        self.range.__enter__()
        _stack.append(self)
        self.t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        _stack.pop()
        self.range.__exit__(*exc)
        _add(self.key + ".ns", ns)
        _add(self.key + ".self_ns", ns - self.child)
        _add(self.key + ".n", 1)
        _add(self.key + ".syncs", 0)
        if _stack:
            _stack[-1].child += ns
        return False


def span(name: str):
    """A context that times the host inside it as `span.<name>.*`, and
    a shared no-op while the tracer is off."""
    return _Span(name) if _on else _OFF


def since(before: Dict[str, int]) -> Dict[str, int]:
    """What each counter gained since the snapshot `before`
    (`dict(counters)` taken then)."""
    return {k: v - before.get(k, 0) for k, v in counters.items()}


def spans(counts: Optional[Dict[str, int]] = None
          ) -> Dict[str, Dict[str, int]]:
    """{name: {"ns", "self_ns", "n", "syncs"}} of every span in `counts`
    (all of `counters` by default)."""
    out: Dict[str, Dict[str, int]] = {}
    for key, v in (counters if counts is None else counts).items():
        if key.startswith("span."):
            name, _, field = key[5:].rpartition(".")
            out.setdefault(name, {})[field] = v
    return out


# -- synchronizing CUDA operations -------------------------------------------

def _synced() -> None:
    for s in _stack:
        _add(s.key + ".syncs", 1)


def _watch_syncs(on: bool) -> None:
    """Count the sync debug mode's warnings instead of printing them
    (the mode is set only where CUDA is there).  The filter and
    `showwarning` are put in and taken out by hand, not by a
    `catch_warnings` held open, so that turning the tracer off restores
    nothing that another warnings context set meanwhile."""
    global _saved
    if on:
        shown = warnings.showwarning

        def showwarning(message, *args, **kw):
            if _on and str(message).startswith(SYNC_WARNING):
                _synced()
            else:
                shown(message, *args, **kw)
        warnings.filterwarnings("always", message=SYNC_WARNING)
        entry = warnings.filters[0]
        warnings.showwarning = showwarning
        mode = None
        if torch.cuda.is_available():
            mode = torch.cuda.get_sync_debug_mode()
            with warnings.catch_warnings():
                # set_sync_debug_mode's notice that the mode is a prototype
                warnings.simplefilter("ignore")
                torch.cuda.set_sync_debug_mode("warn")
        _saved = (mode, entry, shown, showwarning)
    elif _saved is not None:
        mode, entry, shown, showwarning = _saved
        _saved = None
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
        if entry in warnings.filters:
            warnings.filters.remove(entry)
        if warnings.showwarning is showwarning:
            warnings.showwarning = shown


# -- a trainer's synchronized laps -------------------------------------------

class Clock:
    """Laps of a trainer's parts on the host clock, the device
    synchronized at both ends of each (what `timings` holds)."""

    def __init__(self, dev):
        self.dev = torch.device(dev)
        self._sync()
        self.t = time.perf_counter()

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def lap(self) -> float:
        """ms since the last lap (or the clock's start)."""
        self._sync()
        t, self.t = self.t, time.perf_counter()
        return (self.t - t) * 1e3
