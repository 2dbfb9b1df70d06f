"""One run of one cell: set-up, the measured window, the metrics, the
check against the reference, and the result line's object.

Set-up is everything from the process's start to the window's: imports,
the kernel library's build or cached load, the model build, the reset,
the staggered phases and one warm-up unit of the cell's own traffic
(for PPO, an iteration that the check follows); the traffic's `kind`
names the module (`kinds/<kind>.py`) that drives and checks it.  The
window then runs whole units, the device synchronized after each, until
`seconds` have passed; a rate is all its env-steps over its whole time,
a time per step its whole time over its steps.
"""
from __future__ import annotations

import gc
import time
from typing import Optional

import torch

from . import check, drive, spec, trace


class NoDevice(RuntimeError):
    """The cell's cards are not there; the run prints no result."""


def require_cards(chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: the benchmark runs only on the card")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} cards, "
                       f"{torch.cuda.device_count()} found")


def window(unit, seconds: float, dev):
    """Whole units until `seconds` have passed, the device synchronized
    before the first and after each: (the window's start on the host
    clock, {units, env_steps, seconds}), `seconds` the whole time from
    the start to the synchronize after the last unit."""
    trace.sync(dev)
    t0 = time.perf_counter()
    units = steps = 0
    while True:
        steps += unit()
        trace.sync(dev)
        units += 1
        if time.perf_counter() - t0 >= seconds:
            break
    return t0, dict(units=units, env_steps=steps,
                    seconds=time.perf_counter() - t0)


def instrument(rec: trace.Recorder, readers: dict, d) -> None:
    """Install what the metric readers declare they read."""
    spans, counts = {}, {}
    for mod in readers.values():
        spans.update(getattr(mod, "SPANS", {}))
        counts.update(getattr(mod, "COUNTS", {}))
    for name, target in spans.items():
        rec.add_span(name, target)
    for name, target in counts.items():
        if name not in spans:
            rec.add_count(name, target)
    if any(getattr(m, "PROFILE", False) for m in readers.values()):
        rec.add_profile(trace.PROFILE_TARGET)
    if any(getattr(m, "TIMINGS", False) for m in readers.values()):
        d.timings = []
        rec.timings = d.timings


def run(cell_name: str, seed: int, seconds: float, traced: bool,
        device="cuda", t_start: Optional[float] = None,
        bench: Optional[dict] = None, bench_dir: str = spec.BENCH,
        overrides: Optional[dict] = None) -> dict:
    """The result object of one run.  `overrides` replaces traffic
    parameters (the CPU tests run a cell at a small size)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.Cell(cell_name, bench, bench_dir)
    cell.traffic.update(overrides or {})
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cards(cell.chips)
    readers = spec.readers(cell.metrics(traced), bench_dir)
    rec = trace.Recorder(dev)

    drive.apply_options(cell.config)
    kind = spec.kind(cell.traffic["kind"], bench_dir)
    d = kind.Drive(cell.config, cell.traffic, seed, dev, cell.limits)
    d.setup()
    from mj_envs_torch.physics import kernels as port_kernels

    try:
        if traced:
            instrument(rec, readers, d)
            rec.start()
        launches0 = dict(port_kernels.launches)
        d.mark()
        t0, rec.window = window(d.unit, seconds, dev)
    finally:
        d.close()
        rec.close()
    rec.finish()
    rec.setup_s = t0 - t_start
    steps = rec.window["env_steps"]
    rec.launches = {k: port_kernels.launches[k] - launches0.get(k, 0)
                    for k in port_kernels.launches}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = d.failed()

    metrics = {}
    for m in cell.metrics(traced):
        v = readers[m["name"]].read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # The check, after the program's state is freed but for the rows
    # it compares.
    chk = kind.Check(d, cell, seed)
    del d
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = chk.numbers(dev)
    correct, checked = check.judge(numbers, cell.limits["limits"])

    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu",
            "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct and steps > 0), "attempted": steps,
           "failed": failed, "metrics": metrics, "device": info}
    if traced and rec.profile is not None:
        info["busy_s"] = rec.profile["busy_s"]
        info["window_s"] = rec.profile["window_s"]
        out["breakdown"] = rec.profile["breakdown"]
    out["checked"] = checked
    return out
