"""`bench_torch.py`, the port's bench, on the CPU.

* Its child at 8 envs on the CPU plain path (`--child 8 --device cpu`,
  one step per repeat) prints one JSON line with the median rate, every
  repeat, the launch counts and the task-env layer's parts.
* Without a CUDA device the parent prints the FAILED line and exits
  non-zero: the bench has no CPU rung.
* With `mujoco` installed: the port's `sanitize` of each vendored scene
  loads in `mujoco`, equals the JAX package's `sanitize` of the same
  file, and the live baseline's rate is positive.
"""
import json
import math
import os
import subprocess
import sys

from conftest import requires_mujoco

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench_torch.py")
TASKS = ("hammer", "door", "pen", "relocate")


def _env(**kw):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", **kw)
    return env


def test_child_line_on_the_cpu():
    out = subprocess.run(
        [sys.executable, BENCH, "--child", "8", "--device", "cpu"],
        env=_env(BENCH_STEPS="1"), cwd=ROOT,
        capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, out.stdout
    rec = json.loads(lines[0])
    assert rec["num_envs"] == 8 and rec["device"] == "cpu"
    assert rec["steps_per_repeat"] == 1 and rec["chunk"] == 0
    reps = rec["repeats"]
    assert len(reps) == 5 and all(r > 0 for r in reps)
    assert rec["min"] == min(reps) and rec["max"] == max(reps)
    assert rec["steps_per_s"] == sorted(reps)[2]          # the median
    assert set(rec["launches"]) >= {"fk", "noslip_sweep", "linesearch_cost"}
    assert not any(rec["launches"].values())              # CPU: no kernel
    te = rec["task_env"]
    parts = ("physics", "obs_reward", "reset", "merge")
    assert set(te["ms_per_env_step"]) == set(parts) == set(te["share"])
    assert all(te["ms_per_env_step"][p] >= 0 for p in parts)
    assert math.isclose(sum(te["share"].values()), 1.0, rel_tol=1e-9)
    assert te["share"]["physics"] > 0.5      # five substeps dominate
    assert rec["nan_resets"] == 0
    assert "baseline_steps_per_s" in rec and "baseline_error" in rec
    assert (rec["baseline_error"] is None) == (
        rec["baseline_steps_per_s"] == rec["baseline_steps_per_s"])


def test_no_cpu_rung_without_a_card():
    out = subprocess.run([sys.executable, BENCH],
                         env=_env(CUDA_VISIBLE_DEVICES=""), cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["metric"] == "hammer-v0 env-steps/s/chip (FAILED to measure)"
    assert last["value"] == 0.0 and "CUDA" in last["error"]
    assert "cpu" not in last["metric"].lower()


@requires_mujoco
def test_sanitized_scenes_and_baseline():
    import mujoco
    from mj_envs_tpu.mjcf import oracle as J
    from mj_envs_torch.mjcf import oracle as O, task_xml_path
    for task in TASKS:
        xml = O.sanitize(task_xml_path(task))
        assert xml == J.sanitize(task_xml_path(task)), task
        mm = mujoco.MjModel.from_xml_string(xml)
        assert mm.nq == O.load(task).nq > 0
    sys.path.insert(0, ROOT)
    import bench_torch
    rate, why = bench_torch.baseline_steps_per_s()
    assert why is None and rate > 0
