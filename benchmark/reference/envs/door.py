"""door-v0: undo the latch and swing the door open
(`mj_envs_tpu/envs/door.py`).

Obs/reward/reset follow the reference `door_v0.py`: obs `:87-101`,
reward `:62-85`, reset `:103-118` (frame position randomization),
frame_skip 1 (`:10,22`), success `:147-155`.
"""
from __future__ import annotations

import torch

from .base import AdroitEnv, ModelVar
from ..physics.maths import norm
from ..physics.model import Data, Model


class DoorEnv(AdroitEnv):
    TASK = "door"
    FRAME_SKIP = 1
    MAX_EPISODE_STEPS = 200
    OBS_DIM = 39
    SUCCESS_STEPS = 25

    def _resolve_ids(self):
        s = self.spec
        # The door hinge's dof index equals its qpos address (1-dof joints).
        self.door_hinge_did = s.name2id("joint", "door_hinge")
        self.grasp_sid = s.name2id("site", "S_grasp")
        self.handle_sid = s.name2id("site", "S_handle")
        self.door_bid = s.name2id("body", "frame")

    def _reset_var(self, var: ModelVar, gen: torch.Generator) -> ModelVar:
        B = var.body_pos.shape[0]
        for axis, (lo, hi) in enumerate(((-0.3, -0.2), (0.25, 0.35),
                                         (0.252, 0.35))):
            var.body_pos[:, self.door_bid, axis] = self._uniform(gen, B, lo, hi)
        return var

    def _obs(self, model: Model, d: Data) -> torch.Tensor:
        qp = d.qpos
        handle_pos = d.site_xpos[:, self.handle_sid]
        palm_pos = d.site_xpos[:, self.grasp_sid]
        door_pos = qp[:, self.door_hinge_did]
        one = torch.ones_like(door_pos)
        door_open = torch.where(door_pos > 1.0, one, -one)
        return torch.cat([
            qp[:, 1:-2], qp[:, -1:], door_pos[:, None], palm_pos, handle_pos,
            palm_pos - handle_pos, door_open[:, None]], dim=1)

    def _reward_done(self, model: Model, d: Data):
        handle_pos = d.site_xpos[:, self.handle_sid]
        palm_pos = d.site_xpos[:, self.grasp_sid]
        door_pos = d.qpos[:, self.door_hinge_did]
        reward = (-0.1 * norm(palm_pos - handle_pos)
                  - 0.1 * (door_pos - 1.57) * (door_pos - 1.57)
                  - 1e-5 * (d.qvel ** 2).sum(-1))
        zero = torch.zeros_like(reward)
        reward = reward + torch.where(door_pos > 0.2, zero + 2.0, zero)
        reward = reward + torch.where(door_pos > 1.0, zero + 8.0, zero)
        reward = reward + torch.where(door_pos > 1.35, zero + 10.0, zero)
        goal_achieved = door_pos >= 1.35
        done = torch.zeros_like(goal_achieved)   # door never terminates
        return reward, done, goal_achieved
