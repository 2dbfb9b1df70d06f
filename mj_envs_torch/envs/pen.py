"""pen-v0: in-hand pen reorientation to a randomized target orientation
(`mj_envs_tpu/envs/pen.py`).

Obs/reward/reset follow the reference `pen_v0.py`: obs `:104-113`,
reward and drop termination `:66-102` (the only task that terminates),
reset `:115-123` (target body_quat from random x, y Euler angles),
success threshold 20 steps `:180-188`.  `pen_length`/`tar_length` are
frozen at construction (`:57-58`): site offset norms on one body, so
orientation independent.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import AdroitEnv, ModelVar
from ..physics.maths import norm
from ..physics.model import Data, Model
from ..utils import quatmath as Q


class PenEnv(AdroitEnv):
    TASK = "pen"
    FRAME_SKIP = 5
    MAX_EPISODE_STEPS = 100
    OBS_DIM = 45
    VAR_FIELDS = ("body_quat",)
    SUCCESS_STEPS = 20

    def _resolve_ids(self):
        s = self.spec
        self.target_obj_bid = s.name2id("body", "target")
        self.S_grasp_sid = s.name2id("site", "S_grasp")
        self.obj_bid = s.name2id("body", "Object")
        self.eps_ball_sid = s.name2id("site", "eps_ball")
        self.obj_t_sid = s.name2id("site", "object_top")
        self.obj_b_sid = s.name2id("site", "object_bottom")
        self.tar_t_sid = s.name2id("site", "target_top")
        self.tar_b_sid = s.name2id("site", "target_bottom")
        sp = self.model.site_pos.cpu().numpy()
        self.pen_length = float(np.linalg.norm(
            sp[self.obj_t_sid] - sp[self.obj_b_sid]))
        self.tar_length = float(np.linalg.norm(
            sp[self.tar_t_sid] - sp[self.tar_b_sid]))

    def _reset_var(self, var: ModelVar, gen: torch.Generator) -> ModelVar:
        B = var.body_quat.shape[0]
        euler = torch.stack([self._uniform(gen, B, -1.0, 1.0),
                             self._uniform(gen, B, -1.0, 1.0),
                             torch.zeros(B, dtype=self.dtype,
                                         device=self.device)], dim=1)
        var.body_quat[:, self.target_obj_bid] = Q.euler2quat(euler)
        return var

    def _orientations(self, d: Data):
        obj_orien = (d.site_xpos[:, self.obj_t_sid]
                     - d.site_xpos[:, self.obj_b_sid]) / self.pen_length
        desired_orien = (d.site_xpos[:, self.tar_t_sid]
                         - d.site_xpos[:, self.tar_b_sid]) / self.tar_length
        return obj_orien, desired_orien

    def _obs(self, model: Model, d: Data) -> torch.Tensor:
        obj_pos = d.xpos[:, self.obj_bid]
        desired_pos = d.site_xpos[:, self.eps_ball_sid]
        obj_orien, desired_orien = self._orientations(d)
        return torch.cat([
            d.qpos[:, :-6], obj_pos, d.qvel[:, -6:], obj_orien,
            desired_orien, obj_pos - desired_pos,
            obj_orien - desired_orien], dim=1)

    def _reward_done(self, model: Model, d: Data):
        obj_pos = d.xpos[:, self.obj_bid]
        desired_loc = d.site_xpos[:, self.eps_ball_sid]
        obj_orien, desired_orien = self._orientations(d)
        dist = norm(obj_pos - desired_loc)
        orien_similarity = (obj_orien * desired_orien).sum(-1)
        reward = -dist + orien_similarity
        zero = torch.zeros_like(reward)
        close = dist < 0.075
        reward = reward + torch.where(close & (orien_similarity > 0.90),
                                      zero + 10.0, zero)
        reward = reward + torch.where(close & (orien_similarity > 0.95),
                                      zero + 50.0, zero)
        dropped = obj_pos[:, 2] < 0.075
        reward = reward + torch.where(dropped, zero - 5.0, zero)
        goal_achieved = close & (orien_similarity > 0.95)
        return reward, dropped, goal_achieved
