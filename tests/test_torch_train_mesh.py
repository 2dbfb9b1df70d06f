"""PPO training over a mesh through the CLI (`mj_envs_torch/run.py`,
`utils/train.train_ppo_policy(mesh=...)`) and the gather's tracing
(`algos/ppo.py`), on the CPU in a gloo group of two ranks spawned here.

The ranks are this file run as a script (`--worker`), each given
torchrun's variables on a free localhost port and killed on a timeout
(`tests/test_torch_distributed.py`'s way).  Each rank runs
`python -m mj_envs_torch.run <config> ppo` on door-v0 at 4 envs a rank
(n_steps 2, 2 iterations, a checkpoint at the second), then joins a
second group and runs one mesh iteration three ways: plain, with the
tracer on, and timed.  The tests hold:

* the mesh run's checkpoint (parameters, Adam's state, both generators)
  and its metrics.csv rows (every column but the times) equal a single
  process's `train_ppo_policy` over the global 8 envs, bit for bit (its
  8 envs in one chunk, the ranks' in one of 4 each); rank 0 alone wrote
  them;
* without torchrun's variables `run.py` joins no group and trains as the
  plain loop of `make_ppo` does, bit for bit;
* the span `ppo.gather`, the counter `ppo.gather_bytes` (the other
  rank's rows, counted from their shapes) and the timings `wait_ms`,
  `gather_ms`, `rollout_ms_max` and `rollout_ms_min` appear only over a
  mesh, the
  span and counter only with the tracer on, the timings only when
  timings are asked for, and none of them moves the parameters.
"""
import csv
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

_THIS = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(_THIS))
TIMEOUT = 240            # s for the two ranks
PER_RANK, T = 4, 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _config(path, log_path, num_envs):
    cfg = dict(env_name="door-v0", device_type="cpu", seed=3,
               num_envs=num_envs, n_steps=T, n_minibatches=2, n_epochs=2,
               max_episodes=2, checkpoint_interval=2, test_interval=1000,
               learning_rate=3e-4, grad_clip_norm=0.5, log_path=log_path)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def door():
    from mj_envs_torch import envs
    n = torch.get_num_threads()
    torch.set_num_threads(1)    # xdist workers share the CPU
    yield envs.make("door-v0", device="cpu")
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' CLI run and trace iterations: (the output
    directory, each rank's record)."""
    out = tmp_path_factory.mktemp("mesh")
    cfg = _config(out / "mesh.json", str(out / "mesh"), PER_RANK)
    port, port2 = _free_port(), _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                   LOCAL_RANK=str(rank), CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=ROOT)
        procs.append(subprocess.Popen(
            [sys.executable, _THIS, "--worker", str(cfg), str(out),
             str(port2)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
            assert p.returncode == 0, f"a rank failed:\n{outs[-1][-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out, outs, [torch.load(out / f"trace{r}.pt", weights_only=False)
                       for r in range(2)]


def _untimed(rows):
    """metrics.csv's rows without the rate and the laps (host times)."""
    return [{k: v for k, v in r.items()
             if k != "steps_per_s" and "_ms" not in k} for r in rows]


def _csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _checkpoint_equal(a, b):
    a = torch.load(a, weights_only=True)
    b = torch.load(b, weights_only=True)

    def walk(x, y, key):
        if isinstance(x, dict):
            assert set(x) == set(y), key
            for k in x:
                walk(x[k], y[k], f"{key}.{k}")
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), key
        else:
            assert x == y, key
    walk(a, b, "ckpt")


def test_mesh_run_equals_one_process_over_the_global_batch(ranks, door):
    from mj_envs_torch.utils import config as TC
    from mj_envs_torch.utils import train as TT
    out, outs, _ = ranks
    single = str(out / "single")
    config = TC.load_config(
        _config(out / "single.json", single, 2 * PER_RANK), "ppo")
    TT.train_ppo_policy(config, door, single)
    mesh = out / "mesh"
    _checkpoint_equal(mesh / "ckpt_00000002.pt",
                      os.path.join(single, "ckpt_00000002.pt"))
    got, want = _csv(mesh / "metrics.csv"), _csv(
        os.path.join(single, "metrics.csv"))
    assert len(got) == 2 and _untimed(got) == _untimed(want)
    assert {"gather_ms", "rollout_ms_max"} <= set(got[0])
    assert not {"gather_ms", "rollout_ms_max"} & set(want[0])
    # rank 0 alone logged, and counted the global batch's env-steps
    assert "ep     1" in outs[0] and "ep     1" not in outs[1]
    assert "done in" in outs[0] and "done in" not in outs[1]


def test_run_without_torchrun_is_the_plain_loop(tmp_path, door,
                                                monkeypatch):
    from torch import distributed as dist
    from mj_envs_torch import run as trun
    from mj_envs_torch.algos import ppo as TP
    from mj_envs_torch.utils import checkpoint as CKPT
    from mj_envs_torch.utils import train as TT
    from mj_envs_torch.utils.config import load_config
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    cfg = _config(tmp_path / "c.json", str(tmp_path / "run"), 2 * PER_RANK)
    trun.main(["run", str(cfg), "ppo"])
    assert not dist.is_initialized()
    c = load_config(str(cfg), "ppo")
    init_fn, it, _ = TP.make_ppo(door, c.num_envs, TT.ppo_config(c),
                                 device="cpu")
    ts = init_fn(c.seed)
    es = door.reset(c.num_envs, ts.reset_generator)
    for _ in range(c.max_episodes):
        ts, es, _ = it(ts, es)
    CKPT.save(str(tmp_path / "plain.pt"), ts)
    _checkpoint_equal(tmp_path / "run" / "ckpt_00000002.pt",
                      tmp_path / "plain.pt")


def test_gather_traced_and_timed_only_over_a_mesh(ranks, door):
    from mj_envs_torch import trace
    from mj_envs_torch.algos import ppo as TP
    _, _, recs = ranks
    k = PER_RANK
    want_bytes = (T * k * (door.OBS_DIM + door.nu) * 4   # obs, action
                  + 6 * T * k * 4                        # floats a row
                  + T * k                                # done
                  + 8)                                   # nan_resets
    for r in recs:
        plain, traced, timed = r["plain"], r["traced"], r["timed"]
        assert not any(key.startswith("span.ppo.") or key.startswith("ppo.")
                       for key in plain["gained"])
        assert traced["gained"]["span.ppo.gather.n"] == 1
        assert traced["gained"]["ppo.gather_bytes"] == want_bytes
        assert not any(key.startswith("span.ppo.") or key.startswith("ppo.")
                       for key in timed["gained"])
        assert plain["timings"] is None and traced["timings"] is None
        t = timed["timings"]
        assert {"rollout_ms", "gae_ms", "wait_ms", "gather_ms", "update_ms",
                "rollout_ms_max", "rollout_ms_min"} <= set(t)
        assert t["rollout_ms_min"] <= t["rollout_ms"] <= t["rollout_ms_max"]
        for other in (traced, timed):
            assert all(torch.equal(a, b) for a, b in zip(plain["params"],
                                                         other["params"]))
    a, b = (r["timed"]["timings"] for r in recs)
    assert (a["rollout_ms_max"], a["rollout_ms_min"]) == (
        b["rollout_ms_max"], b["rollout_ms_min"])
    assert {a["rollout_ms"], b["rollout_ms"]} == {a["rollout_ms_max"],
                                                  a["rollout_ms_min"]}
    # one process: neither span, counter nor the mesh's timings
    cfg = TP.PPOConfig(n_steps=T, n_minibatches=2, n_epochs=1)
    init_fn, it, _ = TP.make_ppo(door, 2 * k, cfg, device="cpu")
    ts = init_fn(0)
    es = door.reset(2 * k, ts.reset_generator)
    timings = {}
    trace.enable()
    try:
        before = dict(trace.counters)
        it(ts, es, timings=timings)
        gained = trace.since(before)
    finally:
        trace.enable(False)
    assert "span.ppo.gather.n" not in gained
    assert "ppo.gather_bytes" not in gained
    assert set(timings) == {"rollout_ms", "gae_ms", "update_ms"}


# -- the ranks -----------------------------------------------------------------

def _iterations(env, port2):
    """One mesh iteration from the same start, plain, with the tracer on
    and timed: what the counters gained, the timings, the params."""
    from torch import distributed as dist
    from mj_envs_torch import trace
    from mj_envs_torch.algos import ppo as TP
    from mj_envs_torch.parallel import distributed as D
    from mj_envs_torch.parallel.vector import VectorEnv
    D.initialize(f"tcp://127.0.0.1:{port2}", 2, dist_rank(), device="cpu")
    try:
        mesh = D.make_mesh(device="cpu")
        cfg = TP.PPOConfig(n_steps=T, n_minibatches=2, n_epochs=1)
        init_fn, it, _ = TP.make_ppo(env, 2 * PER_RANK, cfg, device="cpu",
                                     mesh=mesh)
        out = {}
        for name, on, timed in (("plain", False, False),
                                ("traced", True, False),
                                ("timed", False, True)):
            ts = init_fn(0)
            es = VectorEnv(env, 2 * PER_RANK, mesh=mesh).reset(1)
            timings = {} if timed else None
            trace.enable(on)
            try:
                before = dict(trace.counters)
                ts, _, _ = it(ts, es, timings=timings)
                gained = {k: v for k, v in trace.since(before).items() if v}
            finally:
                trace.enable(False)
            out[name] = dict(gained=gained, timings=timings, params=[
                p.detach().clone() for p in ts.module.parameters()])
        return out
    finally:
        dist.destroy_process_group()


def dist_rank() -> int:
    return int(os.environ["RANK"])


def _worker(cfg, out, port2):
    from mj_envs_torch import envs
    from mj_envs_torch import run as trun
    torch.set_num_threads(1)
    trun.main(["run", cfg, "ppo"])
    rec = _iterations(envs.make("door-v0", device="cpu"), port2)
    torch.save(rec, os.path.join(out, f"trace{dist_rank()}.pt"))


if __name__ == "__main__":
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        _worker(*sys.argv[i + 1:i + 4])
