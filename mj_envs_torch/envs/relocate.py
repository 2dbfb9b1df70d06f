"""relocate-v0: pick up the ball and move it to a floating target
(`mj_envs_tpu/envs/relocate.py`).

Obs/reward/reset follow the reference `relocate_v0.py`: obs `:74-83`,
staged reward `:54-72`, reset `:85-94` (object xy and target xyz
randomization), success `:131-139`.
"""
from __future__ import annotations

import torch

from .base import AdroitEnv, ModelVar
from ..physics.maths import norm
from ..physics.model import Data, Model


class RelocateEnv(AdroitEnv):
    TASK = "relocate"
    FRAME_SKIP = 5
    MAX_EPISODE_STEPS = 200
    OBS_DIM = 39
    VAR_FIELDS = ("body_pos", "site_pos")
    SUCCESS_STEPS = 25

    def _resolve_ids(self):
        s = self.spec
        self.target_obj_sid = s.name2id("site", "target")
        self.S_grasp_sid = s.name2id("site", "S_grasp")
        self.obj_bid = s.name2id("body", "Object")

    def _reset_var(self, var: ModelVar, gen: torch.Generator) -> ModelVar:
        B = var.body_pos.shape[0]
        var.body_pos[:, self.obj_bid, 0] = self._uniform(gen, B, -0.15, 0.15)
        var.body_pos[:, self.obj_bid, 1] = self._uniform(gen, B, -0.15, 0.3)
        for axis, (lo, hi) in enumerate(((-0.2, 0.2), (-0.2, 0.2),
                                         (0.15, 0.35))):
            var.site_pos[:, self.target_obj_sid, axis] = self._uniform(
                gen, B, lo, hi)
        return var

    def _obs(self, model: Model, d: Data) -> torch.Tensor:
        obj_pos = d.xpos[:, self.obj_bid]
        palm_pos = d.site_xpos[:, self.S_grasp_sid]
        target_pos = d.site_xpos[:, self.target_obj_sid]
        return torch.cat([d.qpos[:, :-6], palm_pos - obj_pos,
                          palm_pos - target_pos, obj_pos - target_pos], dim=1)

    def _reward_done(self, model: Model, d: Data):
        obj_pos = d.xpos[:, self.obj_bid]
        palm_pos = d.site_xpos[:, self.S_grasp_sid]
        target_pos = d.site_xpos[:, self.target_obj_sid]
        ot = norm(obj_pos - target_pos)
        lifted = obj_pos[:, 2] > 0.04
        reward = -0.1 * norm(palm_pos - obj_pos)
        zero = torch.zeros_like(reward)
        reward = reward + torch.where(
            lifted, 1.0 - 0.5 * norm(palm_pos - target_pos) - 0.5 * ot, zero)
        reward = reward + torch.where(ot < 0.1, zero + 10.0, zero)
        reward = reward + torch.where(ot < 0.05, zero + 20.0, zero)
        goal_achieved = ot < 0.1
        done = torch.zeros_like(goal_achieved)   # relocate never terminates
        return reward, done, goal_achieved
