"""What a traced run (--trace 1) records, from the benchmark's own files.

The recorder wraps, at run time, module attributes that the port calls
through, and edits no file of the port:

* spans: host clock around a call, the device synchronized at the
  call's start and end, so that a span holds the work it queued; summed
  by name with their counts;
* counts: calls of a target, with no synchronization;
* two profiled slices: the first two calls of a target after `start()`,
  under `torch.profiler`, with no span synchronizing inside them; after
  the window they are reduced to summaries (from the first, traced with
  the device's activity alone: busy and wall seconds, operations
  launched, the roofline sums of the K1-K6 launches inside it; from the
  second, traced with the host's ops too: the device operations that
  took most time and the idle gaps by what the host was doing).  No
  trace file is written.

The metric readers (`metrics/*.py`) declare what they read: `SPANS` and
`COUNTS` ({name: "module:attribute"}), `PROFILE` and `TIMINGS` (True).
"""
from __future__ import annotations

import bisect
import importlib
import re
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

from . import bounds

# The profiled slice: one chunk's auto-resetting env step (the physics
# substeps, obs, reward, the chunk's in-step reset and the merge).
PROFILE_TARGET = "mj_envs_torch.envs.base:AdroitEnv._step_auto_reset_pair"


def resolve(target: str):
    """(owner, attribute name) of "module:Attr.attr"."""
    mod, _, path = target.partition(":")
    owner = importlib.import_module(mod)
    *outer, attr = path.split(".")
    for name in outer:
        owner = getattr(owner, name)
    return owner, attr


class Patches:
    """Attribute replacements, undone in reverse order by `undo()`."""

    def __init__(self):
        self._done: List = []

    def wrap(self, target: str, make: Callable[[Callable], Callable]):
        owner, attr = resolve(target)
        orig = owner.__dict__[attr] if isinstance(owner, type) \
            else getattr(owner, attr)
        setattr(owner, attr, make(orig))
        self._done.append((owner, attr, orig))

    def undo(self):
        while self._done:
            owner, attr, orig = self._done.pop()
            setattr(owner, attr, orig)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Recorder:
    """Spans, counts and one profiled slice of a traced run, plus what
    every run records (the window, the set-up time, the port's kernel
    launch counters over the window)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.patches = Patches()
        self.span_s: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.spans_on = False
        self.pending: List[str] = []
        self.profiled = False
        self._slices: dict = {}
        self.in_slice = False
        self.profile: Optional[dict] = None
        self.timings: Optional[List[dict]] = None
        self.window: dict = {}
        self.setup_s: Optional[float] = None
        self.launches: Dict[str, int] = {}
        self._bound_s = 0.0
        self._bound_n = 0

    # -- instrumentation ----------------------------------------------------

    def add_span(self, name: str, target: str) -> None:
        rec = self

        def make(orig):
            def span(*a, **k):
                rec.calls[name] += 1
                if not rec.spans_on:
                    return orig(*a, **k)
                sync(rec.device)
                t0 = time.perf_counter()
                out = orig(*a, **k)
                sync(rec.device)
                rec.span_s[name] += time.perf_counter() - t0
                return out
            return span
        self.patches.wrap(target, make)

    def add_count(self, name: str, target: str) -> None:
        rec = self

        def make(orig):
            def count(*a, **k):
                rec.calls[name] += 1
                return orig(*a, **k)
            return count
        self.patches.wrap(target, make)

    def add_profile(self, target: str) -> None:
        """Profile the first two calls of `target` after `start()`: the
        first with the device's activity alone (busy and wall seconds,
        operations launched, the K1-K6 launches' bounds and device time),
        the second with the host's ops too (the breakdown: the host's ops
        slow the first's wall several times over)."""
        rec = self

        def make(orig):
            def sliced(*a, **k):
                if not rec.pending:
                    return orig(*a, **k)
                out = rec._profiled(rec.pending.pop(0), orig, a, k)
                rec.spans_on = not rec.pending
                return out
            return sliced
        self.patches.wrap(target, make)
        self.profiled = True
        for launch, bound in bounds.LAUNCHES.items():
            self.patches.wrap(launch, self._bounded(bound))

    def _bounded(self, bound):
        rec = self

        def make(orig):
            def launch(*a, **k):
                if rec.in_slice:
                    rec._bound_s += bound(*a, **k)
                    rec._bound_n += 1
                return orig(*a, **k)
            return launch
        return make

    def start(self) -> None:
        """Spans on at once, or, where a slice is to be profiled, after
        the two slices (no span synchronizes inside them)."""
        if self.profiled:
            self.pending = ["numbers", "breakdown"]
        else:
            self.spans_on = True

    def _profiled(self, kind: str, fn, a, k):
        """Run fn under kineto, started and stopped by the autograd
        profiler's own calls: its events are kept unparsed (parsing a
        chunk step's ~10^5 events into Python objects takes minutes)."""
        from torch.autograd import _disable_profiler
        from torch.autograd.profiler import profile
        cuda = self.device.type == "cuda"
        p = profile(use_device="cuda" if cuda else None, use_kineto=True,
                    use_cpu=kind == "breakdown" or not cuda)
        calls0 = dict(self.calls)
        sync(self.device)
        p._prepare_trace()
        p._start_trace()
        try:
            self.in_slice = kind == "numbers"
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync(self.device)
            wall = time.perf_counter() - t0
        finally:
            self.in_slice = False
            result = _disable_profiler()
        self._slices[kind] = (result, wall, {
            n: c - calls0.get(n, 0) for n, c in self.calls.items()})
        return out

    def finish(self) -> None:
        """Reduce the profiled slices to summaries (after the window)."""
        if "numbers" not in self._slices:
            return
        result, wall, calls = self._slices.pop("numbers")
        self.profile = summarize(result.events(), wall)
        self.profile.update(calls=calls, bound_s=self._bound_s,
                            bound_launches=self._bound_n)
        if "breakdown" in self._slices:
            result, wall, _ = self._slices.pop("breakdown")
            self.profile["breakdown"] = summarize(result.events(),
                                                  wall)["breakdown"]

    def close(self) -> None:
        self.patches.undo()

    # -- what readers read --------------------------------------------------

    def span_share(self, part: str, whole: str) -> Optional[float]:
        if self.span_s.get(whole, 0.0) <= 0.0 or part not in self.span_s:
            return None
        return self.span_s[part] / self.span_s[whole]


def _short(name: str) -> str:
    """A kernel's or op's name without its argument list."""
    return name.split("(")[0].strip()[:120]


def summarize(events, wall_s: float) -> dict:
    """Summaries of one profiled slice from its kineto events: device busy
    seconds (the union of the device operations' intervals), the wall
    seconds, the operations launched, the K1-K6 kernels' device seconds
    and count, device seconds by operation, and idle seconds by the host
    op running at each gap (the innermost one holding the gap's middle)."""
    from torch.autograd import DeviceType
    dev, cpu = [], []
    for e in events:
        iv = (e.start_ns(), e.end_ns(), e.name())
        (dev if e.device_type() == DeviceType.CUDA else cpu).append(iv)
    dev.sort()
    cpu.sort()
    by_op: Dict[str, float] = defaultdict(float)
    k_pat = re.compile(r"\b(" + "|".join(bounds.KERNEL_NAMES) + r")\b")
    k_ns, k_n = 0, 0
    for s, e, name in dev:
        by_op[_short(name)] += (e - s) * 1e-9
        if k_pat.search(name):
            k_ns += e - s
            k_n += 1
    busy, gaps = 0, []
    cur_s = cur_e = None
    prev_end = cpu[0][0] if cpu else (dev[0][0] if dev else 0)
    for s, e, _ in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        if s > prev_end:
            gaps.append((prev_end, s))
        prev_end = max(prev_end, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    starts = [c[0] for c in cpu]
    idle: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        idle[_host_op(cpu, starts, (g0 + g1) // 2)] += (g1 - g0) * 1e-9
    top = lambda d: [[n, v] for n, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    return dict(busy_s=busy * 1e-9, window_s=wall_s, device_ops=len(dev),
                kernel_s=k_ns * 1e-9, kernel_events=k_n,
                breakdown=dict(device_ops=top(by_op), idle_gaps=top(idle)))


def _host_op(cpu, starts, t, look_back: int = 256) -> str:
    """The innermost host op (latest start) whose interval holds t."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - look_back), -1):
        s, e, name = cpu[j]
        if s <= t <= e:
            return "host: " + _short(name)
    return "host: between ops"
