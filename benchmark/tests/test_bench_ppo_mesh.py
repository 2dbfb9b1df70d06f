"""The kind `ppo_mesh` (`kinds/ppo_mesh.py`) on the CPU: its cell at a
small size, ranks joined by gloo (rank 0 in this process, the others
spawned), and the three readers of its laps.

* A sound run reads `correct` true, every env restarting in the checked
  warm-up step (the episode phases one or two steps short of the cap),
  so that the restarts' draws are held too.
* A worker killed during the window ends rank 0's process with a
  non-zero exit well inside the group's timeout, and leaves no worker
  running.
* The readers from hand-built records, and nothing where the program
  laps no gather and reduces no rollout time.
The faults: `test_bench_ppo_mesh_faults.py`.
"""
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark.lib import harness, spec

CELL = "hammer.ppo.4x1024"
SMALL = {"ranks": 2, "num_envs": 8, "n_steps": 1, "n_minibatches": 2,
         "phase_range": [199, 200]}
ROOT = spec.ROOT


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Rank 0 on one thread, as each spawned rank on the CPU is."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(seed=2**31 + 11, **over):
    return harness.run(CELL, seed, 0.1, False, device="cpu",
                       overrides=dict(SMALL, **over))


def test_sound_run_is_correct():
    r = run()
    assert r["correct"], r["checked"]
    assert r["attempted"] > 0 and r["failed"] == 0
    for name in ("ranks_params_differ", "draws_differ", "reset_err.max"):
        assert r["checked"][name]["value"] == 0.0, name


DIES = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
from benchmark.lib import drive, spec
cell = spec.Cell({cell!r})
cell.traffic.update({small!r})
drive.apply_options(cell.config)
d = spec.kind("ppo_mesh").Drive(cell.config, cell.traffic, 5,
                                torch.device("cpu"), cell.limits)
d.setup()
d.mark()
print(json.dumps([p.pid for p in d.workers]), flush=True)
d.workers[0].kill()
t = time.time()
while time.time() - t < 120:
    d.unit()
print("not ended", flush=True)
"""


def _gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/status") as f:
            return "zombie" in f.read()
    except FileNotFoundError:
        return True


def test_a_dead_worker_ends_rank_0_at_once(tmp_path):
    small = dict(SMALL, ranks=3, num_envs=12)
    code = DIES.format(root=ROOT, cell=CELL, small=small)
    t0 = time.time()
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=240,
                       env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert p.returncode != 0, p.stdout + p.stderr[-3000:]
    assert "not ended" not in p.stdout
    pids = json.loads(p.stdout.splitlines()[0])
    deadline = time.time() + 10
    while not all(map(_gone, pids)) and time.time() < deadline:
        time.sleep(0.2)
    assert all(map(_gone, pids)), pids
    assert time.time() - t0 < 200
    # the work directory removed
    assert not [d for d in os.listdir(tmp_path) if d.startswith("ppo_mesh")]


def _rec(timings, profiled=True):
    return SimpleNamespace(timings=timings, profile={} if profiled else None)


MESH = [
    dict(rollout_ms=900.0, gae_ms=1.0, wait_ms=90.0, gather_ms=9.0,
         update_ms=100.0, rollout_ms_max=1000.0,
         rollout_ms_min=500.0),                             # profiled
    dict(rollout_ms=800.0, gae_ms=1.0, wait_ms=20.0, gather_ms=10.0,
         update_ms=169.0, rollout_ms_max=820.0, rollout_ms_min=779.0),
    dict(rollout_ms=780.0, gae_ms=2.0, wait_ms=20.0, gather_ms=30.0,
         update_ms=168.0, rollout_ms_max=800.0, rollout_ms_min=760.0),
]
# the parent's laps: GAE holds the gather, nothing reduced over the ranks
PLAIN = [dict(rollout_ms=800.0, gae_ms=31.0, update_ms=169.0)] * 3


@pytest.mark.parametrize("name,profiled,want", [
    ("ppo.gather_ms.dp4", True, 20.0),
    ("ppo.gather_ms.dp4", False, (9.0 + 10.0 + 30.0) / 3),
    ("ppo.rank_skew.dp4", True, (41 / 820 + 40 / 800) / 2),
    ("ppo.update_share.dp4", True, 337.0 / 2000.0),
])
def test_readers(name, profiled, want):
    read = spec.reader(name).read
    assert read(_rec(MESH, profiled)) == pytest.approx(want)
    assert read(_rec([])) is None


@pytest.mark.parametrize("name,want", [
    ("ppo.gather_ms.dp4", None), ("ppo.rank_skew.dp4", None),
    ("ppo.update_share.dp4", 169.0 / 1000.0)])
def test_readers_of_a_program_without_the_mesh_timings(name, want):
    got = spec.reader(name).read(_rec(PLAIN))
    assert got == (pytest.approx(want) if want is not None else None)


def _tie_case(program_side_inside: bool):
    """One Adam step on 64 rows whose row 5 has a float64 ratio just
    above 1 + eps with a positive advantage (clipped in float64), and
    the program's applied gradient computed with row 5 inside the range
    (`program_side_inside`) or clipped, as float64 has it."""
    from benchmark.kinds import ppo_mesh as M
    from benchmark.reference import policy as RP
    from mj_envs_torch.algos.ppo import Transition
    F64 = torch.float64
    g = torch.Generator().manual_seed(3)
    sizes = {"actor": (46, 8, 8, 26), "critic": (46, 8, 8, 1)}
    p = {}
    for head, dims in sizes.items():
        for i, (a, b) in enumerate(zip(dims, dims[1:])):
            p[f"{head}.{i}.weight"] = torch.randn(b, a, generator=g) / a ** 0.5
            p[f"{head}.{i}.bias"] = torch.zeros(b)
    p["log_std"] = torch.zeros(26)
    n, eps = 64, 0.2
    obs = torch.randn(1, n, 46, generator=g)
    p64 = {k: v.to(F64) for k, v in p.items()}
    mean, log_std, _ = RP.forward(p64, obs[0].to(F64))
    action = (mean + torch.randn(n, 26, generator=g, dtype=F64)).float()
    logp = RP.log_prob(mean, log_std, action.to(F64))
    reward = torch.randn(1, n, generator=g)
    reward[0, 5] = 3.0                      # a positive advantage
    ratio = 1 + 0.1 * torch.randn(n, generator=g, dtype=F64)
    ratio[5] = (1 + eps) * (1 + 2e-5)       # clipped, at a tie
    old = (logp - torch.log(ratio)).float()
    zeros = torch.zeros(1, n)
    traj = Transition(obs=obs, action=action[None], log_prob=old[None],
                      value=zeros, reward=reward,
                      done=torch.ones(1, n, dtype=torch.bool),
                      trunc_boot=zeros)
    traffic = dict(n_minibatches=1, n_epochs=1, clip_eps=eps, gamma=0.99,
                   gae_lambda=0.95, learning_rate=3e-4, grad_clip_norm=0.5,
                   vf_coef=0.5, ent_coef=0.0)
    lp = old.to(F64).clone()
    if program_side_inside:
        lp[5] = logp[5] - torch.log(torch.tensor((1 + eps) * (1 - 1e-3),
                                                 dtype=F64))
    adv = reward[0].to(F64)
    _, first, _ = RP.update_steps(p64, [(obs[0].to(F64), action.to(F64), lp,
                                         adv, adv)], 3e-4, 0.5, eps, 0.5, 0.0)
    it = object.__new__(M._Global)
    it.traj, it.last_value = traj, torch.zeros(n)
    it.perms = torch.randperm(n, generator=g)[None]
    it.params0, it.nudges = p, {}
    it.updates = [(torch.cat([v.reshape(-1) for v in p.values()]),
                   torch.cat([first[k].float().reshape(-1) for k in p]))]
    return M, it, traffic, first


@pytest.mark.parametrize("inside", [True, False])
def test_a_clip_tie_takes_the_programs_side(inside):
    """A row at a clip tie whose side the program's gradient shows: the
    reference's minibatch puts it there where float64 puts it on the
    other, and leaves it alone where they agree; the reference's
    gradient on the result is the program's."""
    from benchmark.reference import policy as RP
    M, it, t, want = _tie_case(inside)
    nudges = M._ties(it, t)
    row = int(torch.nonzero(it.perms[0] == 5))
    assert set(nudges) == ({(0, row)} if inside else set())
    it.nudges = nudges
    tr = it.traj
    adv = tr.reward.to(torch.float64)
    (b,) = it.batches(t, tr.obs, tr.action, tr.log_prob, adv, adv,
                      torch.float64)
    _, got, _ = RP.update_steps(
        {k: v.to(torch.float64) for k, v in it.params0.items()}, [b],
        3e-4, 0.5, 0.2, 0.5, 0.0)
    gap = max(float((got[k] - want[k]).norm() / want[k].norm().clamp(
        min=1e-12)) for k in want)
    assert gap < 1e-3
