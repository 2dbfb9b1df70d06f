"""Tendon kinematics and actuator forces (`mj_envs_tpu/physics/actuation.py`).

Fixed tendons only (linear couplings over qpos) and general actuators
with joint transmission, fixed gain and affine bias.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .model import Model


class Actuation(NamedTuple):
    ten_length: torch.Tensor         # (B, nten)
    ten_velocity: torch.Tensor       # (B, nten)
    actuator_length: torch.Tensor    # (B, nu)
    actuator_velocity: torch.Tensor  # (B, nu)
    actuator_force: torch.Tensor     # (B, nu)
    qfrc_actuator: torch.Tensor      # (B, nv)


def tendon(m: Model, qpos: torch.Tensor, qvel: torch.Tensor):
    """Fixed-tendon length/velocity; the moment matrix is ten_coef."""
    return qpos @ m.ten_coef.T, qvel @ m.ten_coef.T


def actuation(m: Model, qpos: torch.Tensor, qvel: torch.Tensor,
              ctrl: torch.Tensor) -> Actuation:
    s = m.spec
    ten_length, ten_velocity = tendon(m, qpos, qvel)
    trn = torch.as_tensor(s.act_trnid, dtype=torch.long, device=qpos.device)
    length = qpos[:, trn]
    velocity = qvel[:, trn]

    c = torch.minimum(torch.maximum(ctrl, m.act_ctrlrange[:, 0]),
                      m.act_ctrlrange[:, 1])
    gain = m.act_gainprm[:, 0]
    affine = torch.as_tensor(s.act_biastype == 1, device=qpos.device)
    bias = torch.where(
        affine,
        m.act_biasprm[:, 0] + m.act_biasprm[:, 1] * length
        + m.act_biasprm[:, 2] * velocity,
        torch.zeros_like(length))
    force = gain * c + bias
    clipped = torch.minimum(torch.maximum(force, m.act_forcerange[:, 0]),
                            m.act_forcerange[:, 1])
    force = torch.where(m.act_forcelimited, clipped, force)

    qfrc = torch.zeros_like(qpos).index_add_(1, trn, force)
    return Actuation(
        ten_length=ten_length, ten_velocity=ten_velocity,
        actuator_length=length, actuator_velocity=velocity,
        actuator_force=force, qfrc_actuator=qfrc,
    )
