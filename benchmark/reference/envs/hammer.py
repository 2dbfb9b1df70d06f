"""hammer-v0: drive the nail into the board with the hammer
(`mj_envs_tpu/envs/hammer.py`).

Obs/reward/reset follow the reference `hammer_v0.py`: obs `:92-104`,
reward `:62-88`, reset randomization `:106-129` (board height plus the
optional mass/pos/size variations), success `:167-175`.
"""
from __future__ import annotations

import torch

from .base import AdroitEnv, ModelVar
from ..physics.maths import norm
from ..physics.model import Data, Model
from ..utils import quatmath as Q


class HammerEnv(AdroitEnv):
    TASK = "hammer"
    FRAME_SKIP = 5
    MAX_EPISODE_STEPS = 200
    OBS_DIM = 46
    SUCCESS_STEPS = 25

    def var_fields(self):
        """Board height always (body_pos); variations add their fields."""
        extra = {"mass": ("body_mass", "geom_rgba"),
                 "pos": ("geom_pos",),
                 "size": ("geom_size",)}.get(self.variation_type, ())
        return ("body_pos",) + extra

    def _resolve_ids(self):
        s = self.spec
        self.target_obj_sid = s.name2id("site", "S_target")
        self.S_grasp_sid = s.name2id("site", "S_grasp")
        self.obj_bid = s.name2id("body", "Object")
        self.tool_sid = s.name2id("site", "tool")
        self.goal_sid = s.name2id("site", "nail_goal")
        self.board_bid = s.name2id("body", "nail_board")
        self.head_gid = s.name2id("geom", "head")
        self.neck_gid = s.name2id("geom", "neck")
        self.nail_adr = s.sensors[s.names["sensor"]["S_nail"]][2]

    def _reset_var(self, var: ModelVar, gen: torch.Generator) -> ModelVar:
        B = var.body_pos.shape[0]
        var.body_pos[:, self.board_bid, 2] = self._uniform(gen, B, 0.1, 0.25)
        if self.variation_type == "mass":
            x = self._uniform(gen, B, 0.05, 2.5)
            var.body_mass[:, self.obj_bid] = x
            var.geom_rgba[:, self.head_gid, 0] = x / 2.5
        elif self.variation_type == "pos":
            x = self._uniform(gen, B, -0.24, -0.10)
            var.geom_pos[:, self.head_gid, 0] = x
            var.geom_pos[:, self.neck_gid, 0] = -0.14 - (-0.24 - x)
        elif self.variation_type == "size":
            var.geom_size[:, self.head_gid, 0] = self._uniform(gen, B, 0.01,
                                                               0.04)
            var.geom_size[:, self.head_gid, 1] = self._uniform(gen, B, 0.02,
                                                               0.08)
        elif self.variation_type is not None:
            raise ValueError(
                f"Unsupported variation type {self.variation_type}")
        return var

    def _obs(self, model: Model, d: Data) -> torch.Tensor:
        qv = torch.clamp(d.qvel, -1.0, 1.0)
        nail_impact = torch.clamp(d.sensordata[:, self.nail_adr], -1.0, 1.0)
        return torch.cat([
            d.qpos[:, :-6], qv[:, -6:], d.site_xpos[:, self.S_grasp_sid],
            d.xpos[:, self.obj_bid], Q.quat2euler(d.xquat[:, self.obj_bid]),
            d.site_xpos[:, self.target_obj_sid], nail_impact[:, None]], dim=1)

    def _reward_done(self, model: Model, d: Data):
        obj_pos = d.xpos[:, self.obj_bid]
        palm_pos = d.site_xpos[:, self.S_grasp_sid]
        tool_pos = d.site_xpos[:, self.tool_sid]
        target_pos = d.site_xpos[:, self.target_obj_sid]
        goal_pos = d.site_xpos[:, self.goal_sid]

        tg = norm(target_pos - goal_pos)
        reward = (-0.1 * norm(palm_pos - obj_pos)
                  - norm(tool_pos - target_pos)
                  - 10.0 * tg
                  - 1e-2 * norm(d.qvel))
        lifted = (obj_pos[:, 2] > 0.04) & (tool_pos[:, 2] > 0.04)
        zero = torch.zeros_like(reward)
        reward = reward + torch.where(lifted, zero + 2.0, zero)
        reward = reward + torch.where(tg < 0.020, zero + 25.0, zero)
        reward = reward + torch.where(tg < 0.010, zero + 75.0, zero)
        goal_achieved = tg < 0.010
        done = torch.zeros_like(goal_achieved)   # hammer never terminates
        return reward, done, goal_achieved
