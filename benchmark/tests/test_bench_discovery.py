"""A cell, a traffic mix, a traffic kind and a metric added as new files
and entries are found by name, with no edit of a file the benchmark
has."""
import json
import os
import pathlib
import shutil

import pytest

from benchmark.lib import harness, spec, trace

BENCH = spec.BENCH


@pytest.fixture
def tree(tmp_path):
    """A copy of the benchmark's data files, plus one new cell, mix and
    per-layer metric, each in a file of its own."""
    for d in ("configs", "traffic", "workloads", "metrics", "kinds"):
        shutil.copytree(os.path.join(BENCH, d), tmp_path / d)
    (tmp_path / "traffic" / "rollout_256.json").write_text(json.dumps(
        {"kind": "rollout", "num_envs": 256, "staggered_phase": True}))
    (tmp_path / "workloads" / "door.rollout.256.json").write_text(
        (tmp_path / "workloads" / "door.rollout.4096.json").read_text())
    (tmp_path / "metrics" / "window_units.rollout.py").write_text(
        "def read(rec):\n    return rec.window.get('units')\n")
    bench = spec.benchmark()
    bench["workloads"].append({"name": "door.rollout.256", "config": "door-v0",
                               "traffic": "rollout_256", "chips": 1,
                               "why": "a smaller batch"})
    bench["per_layer"].append({"name": "window_units.rollout", "unit": "units",
                               "better": "higher", "source": "host_clock",
                               "layer": "Vector env", "moves": "env_steps_per_s",
                               "workloads": ["door.rollout.256"]})
    for m in bench["end_to_end"]:
        if m["name"] == "env_steps_per_s":
            m["workloads"].append("door.rollout.256")
    return bench, str(tmp_path)


def test_new_cell_mix_and_metric_found(tree):
    bench, d = tree
    cell = spec.Cell("door.rollout.256", bench, d)
    assert cell.traffic["num_envs"] == 256
    assert cell.config["env_id"] == "door-v0"
    assert [m["name"] for m in cell.metrics(True)] == ["window_units.rollout"]
    assert {m["name"] for m in cell.metrics(False)} == {"env_steps_per_s",
                                                         "setup_s"}
    rd = spec.readers(cell.metrics(True), d)
    rec = trace.Recorder("cpu")
    rec.window = dict(units=7, env_steps=7 * 256, seconds=1.0)
    assert rd["window_units.rollout"].read(rec) == 7


NEW_KIND = '''"""kind `rollout_pairs`: two batched env steps a unit."""
from benchmark.kinds import rollout

Check, FAULTS = rollout.Check, rollout.FAULTS


class Drive(rollout.Drive):
    def unit(self):
        return super().unit() + super().unit()
'''


def test_new_kind_found_and_run(tree):
    bench, d = tree
    root = pathlib.Path(d)
    (root / "kinds" / "rollout_pairs.py").write_text(NEW_KIND)
    (root / "traffic" / "pairs_2.json").write_text(json.dumps(
        {"kind": "rollout_pairs", "num_envs": 2}))
    limits = json.loads(
        (root / "workloads" / "door.rollout.4096.json").read_text())
    limits["check_at"] = 4           # two pairs after the warm-up pair
    (root / "workloads" / "door.pairs.2.json").write_text(json.dumps(limits))
    bench["workloads"].append({"name": "door.pairs.2", "config": "door-v0",
                               "traffic": "pairs_2", "chips": 1,
                               "why": "two steps a unit"})
    bench["end_to_end"][0]["workloads"].append("door.pairs.2")
    kind = spec.kind("rollout_pairs", d)
    assert hasattr(kind, "Drive") and hasattr(kind, "Check")
    r = harness.run("door.pairs.2", 5, 0.05, False, device="cpu",
                    bench=bench, bench_dir=d)
    assert r["attempted"] % 4 == 0 and r["attempted"] > 0
    assert r["correct"], r["checked"]


def test_every_metric_has_its_reader():
    bench = spec.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert hasattr(spec.reader(m["name"]), "read"), m["name"]


@pytest.mark.parametrize("name", [w["name"] for w in spec.benchmark()["workloads"]])
def test_each_cell_resolves(name):
    cell = spec.Cell(name)
    e2e = {m["name"] for m in cell.metrics(False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.metrics(True), "every cell reports a per-layer metric"
    assert all(m["moves"] in e2e for m in cell.metrics(True))
    assert cell.limits["limits"]


def _rollout_files():
    """Every workload file that the kind `rollout` reads: those of the
    cells whose traffic has that kind, and those kept for later cells
    (only that kind reads `check_units`)."""
    names = {w["name"] for w in spec.benchmark()["workloads"]
             if spec.Cell(w["name"]).traffic["kind"] == "rollout"}
    d = os.path.join(BENCH, "workloads")
    names |= {f[:-5] for f in os.listdir(d) if f.endswith(".json")
              and "check_units" in spec.load_json(os.path.join(d, f))}
    return sorted(names)


@pytest.mark.parametrize("name", _rollout_files())
def test_rollout_checks_a_fixed_unit(name):
    lim = spec.load_json(os.path.join(BENCH, "workloads", name + ".json"))
    assert isinstance(lim["check_at"], int)
    assert lim["check_at"] >= lim["check_units"] >= 1


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.Cell("no.such.cell")
