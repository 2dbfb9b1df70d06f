"""kind `rollout`: `num_envs` envs of the configuration through
`VectorEnv.step` (auto-reset, the program's own chunk schedule), one
unit one batched env step, actions uniform in [-1, 1) drawn on the
device from the seed; each env's `step_count` drawn in
[0, max_episode_steps) at set-up (`staggered_phase`), so that some envs
reach the cap in every step, as in a long-running rollout.

The check holds a fixed stretch of units against the reference
(`lib/check.py`): units `check_at` - `check_units` + 1 ... `check_at`,
counted from set-up (the warm-up unit is unit 1), a sample of envs drawn
from the seed in each (every restarted env first), and the initial
reset.  Every env starts from its reset at set-up, so the unit fixes
how deep into their episodes the checked states lie: a faster program
is checked on the same states as a slower one, bit for bit where the
physics is the same.  Units the window ran past `check_at` are not
checked; where the window ended before it, the check steps on, untimed,
with the same action stream, once the window's numbers are read."""
from __future__ import annotations

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
        self.check_at = int(limits["check_at"])
        self.first_checked = self.check_at - int(limits["check_units"]) + 1
        self.units = 0                  # units stepped since set-up
        # (pre-step state, actions, post-step state) of the checked units
        self.checked = []

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
        self.units += 1
        if self.first_checked <= self.units <= self.check_at:
            self.checked.append((pre, a, self.state))
        return self.num_envs

    def step_to_check(self) -> None:
        """Untimed units up to `check_at`, where the window ended before
        it."""
        while self.units < self.check_at:
            self.unit()

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
        # The harness builds the check once it has read the window's
        # numbers and `failed`: the units stepped here are in neither.
        d.step_to_check()
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
