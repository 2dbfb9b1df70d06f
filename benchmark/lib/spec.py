"""Where the harness finds a cell's parts, by the names in BENCHMARK.json.

A cell (an entry of `workloads`) names a configuration and a traffic mix;
each is a JSON file of its own (`configs/<config>.json`,
`traffic/<traffic>.json`); a traffic file's `kind` names the module
`kinds/<kind>.py` that drives and checks it (`Drive`, `Check`,
`FAULTS`).  The cell's correctness limits are in
`workloads/<cell>.json`.  Each metric is read by a module of its own,
`metrics/<metric>.py`, whose `read(rec)` returns a number or None.  A
later cell, mix or metric is a new file and a new entry, never an edit.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import Dict, List, Optional

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic,
    limits and the metrics it reports (end-to-end with --trace 0,
    per-layer with --trace 1)."""

    def __init__(self, name: str, bench: Optional[dict] = None,
                 bench_dir: str = BENCH):
        bench = bench if bench is not None else benchmark()
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"known: {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        self.config = load_json(os.path.join(
            bench_dir, "configs", self.entry["config"] + ".json"))
        self.traffic = load_json(os.path.join(
            bench_dir, "traffic", self.entry["traffic"] + ".json"))
        self.limits = load_json(os.path.join(
            bench_dir, "workloads", name + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _reports(m, name)]
        e2e_names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if _reports(m, name) and m["moves"] in e2e_names]

    def metrics(self, trace: bool) -> List[dict]:
        return self.per_layer if trace else self.end_to_end


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(name: str, bench_dir: str = BENCH) -> ModuleType:
    """The module `metrics/<name>.py`, loaded by its path (a metric's
    name may hold dots)."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str, bench_dir: str = BENCH) -> ModuleType:
    """The module `kinds/<name>.py` of a traffic kind, loaded by its
    path as a module of the package `benchmark.kinds`."""
    full = "benchmark.kinds." + name
    path = os.path.join(bench_dir, "kinds", name + ".py")
    mod = sys.modules.get(full)
    if mod is not None and os.path.abspath(getattr(mod, "__file__", "")) \
            == os.path.abspath(path):
        return mod
    import benchmark.kinds  # noqa: F401  (the package of the kinds)
    spec = importlib.util.spec_from_file_location(full, path)
    if spec is None or not os.path.exists(path):
        raise KeyError(f"no traffic kind {name!r} ({path})")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    spec.loader.exec_module(mod)
    return mod


def readers(metrics: List[dict], bench_dir: str = BENCH
            ) -> Dict[str, ModuleType]:
    return {m["name"]: reader(m["name"], bench_dir) for m in metrics}
