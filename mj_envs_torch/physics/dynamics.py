"""Smooth dynamics: CRB mass matrix, RNE bias forces, passive forces
(`mj_envs_tpu/physics/dynamics.py`), batch-first.

Everything is in the per-tree com frame from `kinematics.kinematics` and
reduced with static-mask matmuls over the env axis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import maths
from .kinematics import Kin
from .model import Model


class Vel(NamedTuple):
    cvel: torch.Tensor       # (B, nbody, 6) body spatial velocity
    cdof_dot: torch.Tensor   # (B, nv, 6) time-derivative of cdof


def _mask(a, dtype, device):
    return torch.as_tensor(a, dtype=dtype, device=device)


def crb(m: Model, kin: Kin) -> torch.Tensor:
    """Composite-rigid-body mass matrix (B, nv, nv), armature included."""
    s = m.spec
    dtype, dev = kin.cdof.dtype, kin.cdof.device
    subtree = _mask(s.subtree_mask, dtype, dev)                 # (nb, nb)
    icomp = torch.einsum("bd,ndij->nbij", subtree, kin.cinert)  # (B,nb,6,6)
    jb = torch.as_tensor(s.jnt_bodyid, dtype=torch.long, device=dev)
    # F[j] = Icomp[body(j)] @ cdof[j]
    F = (icomp[:, jb] * kin.cdof[:, :, None, :]).sum(-1)        # (B, nv, 6)
    M = torch.matmul(kin.cdof, F.transpose(-1, -2))             # (B, nv, nv)
    # M[i, j] is only valid where dof i is on dof j's path (i <= j):
    # keep that triangle and mirror it.
    upper = M * _mask(s.ancestor_mask, dtype, dev)
    diag = torch.diagonal(upper, dim1=-2, dim2=-1)
    M = upper + upper.transpose(-1, -2) - torch.diag_embed(diag)
    return M + torch.diag(m.dof_armature)


def com_velocity(m: Model, kin: Kin, qvel: torch.Tensor) -> Vel:
    s = m.spec
    dtype, dev = qvel.dtype, qvel.device
    cdof_qvel = kin.cdof * qvel[..., None]                      # (B, nv, 6)
    cvel = torch.matmul(_mask(s.body_dofmask, dtype, dev), cdof_qvel)
    v_pred = torch.matmul(_mask(s.dof_strict_pred, dtype, dev), cdof_qvel)
    cdof_dot = maths.motion_cross(v_pred, kin.cdof)
    return Vel(cvel=cvel, cdof_dot=cdof_dot)


def bias_force(m: Model, kin: Kin, vel: Vel, qvel: torch.Tensor
               ) -> torch.Tensor:
    """qfrc_bias = C(q, v) qvel + gravity term (RNE with qacc = 0)."""
    s = m.spec
    dtype, dev = qvel.dtype, qvel.device
    body_dofmask = _mask(s.body_dofmask, dtype, dev)
    # Base "acceleration" encodes gravity: a0 = [0; -g].
    a0 = torch.cat([torch.zeros(3, dtype=dtype, device=dev),
                    -torch.as_tensor(s.gravity, dtype=dtype, device=dev)])
    cacc = a0 + torch.matmul(body_dofmask, vel.cdof_dot * qvel[..., None])
    Iv = (kin.cinert * vel.cvel[..., None, :]).sum(-1)
    Ia = (kin.cinert * cacc[..., None, :]).sum(-1)
    f = Ia + maths.force_cross(vel.cvel, Iv)                    # (B, nb, 6)
    fsum = torch.matmul(body_dofmask.T, f)                      # (B, nv, 6)
    return (kin.cdof * fsum).sum(-1)


def passive_force(m: Model, qpos: torch.Tensor, qvel: torch.Tensor
                  ) -> torch.Tensor:
    """Joint springs and dampers."""
    spring = -m.jnt_stiffness * (qpos - m.jnt_springref)
    damper = -m.dof_damping * qvel
    return spring + damper
