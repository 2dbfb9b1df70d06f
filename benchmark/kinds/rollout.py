"""kind `rollout`: `num_envs` envs of the configuration through
`VectorEnv.step` (auto-reset, the program's own chunk schedule), one
unit one batched env step, actions uniform in [-1, 1) drawn on the
device from the seed; each env's `step_count` drawn in
[0, max_episode_steps) at set-up (`staggered_phase`), so that some envs
reach the cap in every step, as in a long-running rollout.

The check holds the window's last `check_units` steps (a sample of envs
drawn from the seed, every restarted env first) and the initial reset
against the reference (`lib/check.py`)."""
from __future__ import annotations

import collections
from typing import Dict

import torch

from ..lib import check, drive


class Drive:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 limits: dict):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.num_envs = int(traffic["num_envs"])
        self.timings = None
        # (pre-step state, actions, post-step state) of the last units,
        # for the check
        self.checked = collections.deque(maxlen=limits.get("check_units",
                                                           1))

    def setup(self) -> None:
        from mj_envs_torch import envs
        from mj_envs_torch.parallel.vector import VectorEnv
        self.env = envs.make(self.config["env_id"], device=self.device)
        self.vec = VectorEnv(self.env, self.num_envs)
        state = self.vec.reset(drive.sub_seed(self.seed, "reset"))
        if self.traffic.get("staggered_phase"):
            state = drive.staggered(
                state, self.config["max_episode_steps"],
                drive.generator(self.device, self.seed, "phase"))
        self.initial = self.state = state
        self.gen = drive.generator(self.device, self.seed, "actions")
        self.unit()                                   # the warm-up unit

    def unit(self) -> int:
        a = drive.uniform_actions(self.gen, self.num_envs, self.env.nu,
                                  self.device)
        pre, self.state = self.state, self.vec.step(self.state, a)
        self.checked.append((pre, a, self.state))
        return self.num_envs

    def mark(self) -> None:
        self.window_start = self.state

    def close(self) -> None:
        pass

    def failed(self) -> int:
        return drive.failures(self.window_start, self.state)


class Check:
    """Keeps the rows the check needs from the drive, so that the
    program's state can be freed before the reference runs."""

    def __init__(self, d: Drive, cell, seed: int):
        lim = cell.limits
        k, kr = lim["sample_envs"], lim["sample_restarts"]
        self.config = cell.config
        self.steps = []
        for u, (pre, action, post) in enumerate(d.checked):
            rows = check.sample(seed, f"check{u}", post, k, kr)
            self.steps.append((check.rows_of(pre, rows), action[rows],
                               check.rows_of(post, rows)))
        rows0 = check.sample(seed, "start", d.initial, k, 0)
        self.start = check.rows_of(d.initial, rows0)

    def numbers(self, device, control: bool = False) -> Dict[str, float]:
        ref = check.reference_env(self.config["env_id"], device)
        start = self.start
        pres = check.cat_states([p for p, _, _ in self.steps])
        acts = torch.cat([a for _, a, _ in self.steps])
        posts = check.cat_states([q for _, _, q in self.steps])
        if control:
            low = check.reference_env(self.config["env_id"], device,
                                      torch.float32)
            start = check.start_rows(low, start)
            with check.tf32():
                posts = check.auto_reset_step(low, pres, acts, posts.var)
        return check.physics_summary([
            check.reset_numbers(ref, self.config, start),
            check.step_numbers(ref, self.config, pres, acts, posts)])


def _join(new, old, h):
    """Rows [0, h) of `new`, the rest of `old`."""
    return torch.cat([new[:h], old[h:]], dim=0)


def _unchanged(p):
    p.wrap("mj_envs_torch.parallel.vector:VectorEnv.step",
           lambda orig: lambda self, state, actions: state)


def _half_batch(p):
    def make(orig):
        def step(self, state, actions):
            new = orig(self, state, actions)
            h = state.batch // 2
            return new.map(lambda a, b: _join(a, b, h), state)
        return step
    p.wrap("mj_envs_torch.parallel.vector:VectorEnv.step", make)


# The env step returns its state unchanged; half of the batch left out
# (the first half stepped, the rest returned as it was).  The env-level
# faults (`altered`, `merge`) are `lib/faults.py`'s.
FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch}
