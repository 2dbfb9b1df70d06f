"""Rotation conversions of the task layer (`mj_envs_tpu/utils/quatmath.py`),
with the reference's exact formulas: hammer-v0's observation embeds
quat2euler(body_xquat).  Batched over leading axes.
"""
from __future__ import annotations

import numpy as np
import torch

_EPS4 = float(np.finfo(np.float64).eps) * 4.0


def quat2mat(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3); identity for near-zero quats."""
    w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    nq = (quat * quat).sum(-1)
    s = 2.0 / torch.where(nq > 0, nq, torch.ones_like(nq))
    X, Y, Z = x * s, y * s, z * s
    wX, wY, wZ = w * X, w * Y, w * Z
    xX, xY, xZ = x * X, x * Y, x * Z
    yY, yZ, zZ = y * Y, y * Z, z * Z
    mat = torch.stack([
        1.0 - (yY + zZ), xY - wZ, xZ + wY,
        xY + wZ, 1.0 - (xX + zZ), yZ - wX,
        xZ - wY, yZ + wX, 1.0 - (xX + yY),
    ], dim=-1).reshape(quat.shape[:-1] + (3, 3))
    eps = torch.finfo(quat.dtype).eps
    eye = torch.eye(3, dtype=quat.dtype, device=quat.device)
    return torch.where((nq > eps)[..., None, None], mat, eye)


def mat2euler(mat: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) Euler angles (reference convention)."""
    cy = torch.sqrt(mat[..., 2, 2] ** 2 + mat[..., 1, 2] ** 2)
    cond = cy > _EPS4
    e2 = torch.where(cond, -torch.atan2(mat[..., 0, 1], mat[..., 0, 0]),
                     -torch.atan2(-mat[..., 1, 0], mat[..., 1, 1]))
    e1 = -torch.atan2(-mat[..., 0, 2], cy)
    e0 = torch.where(cond, -torch.atan2(mat[..., 1, 2], mat[..., 2, 2]),
                     torch.zeros_like(cy))
    return torch.stack([e0, e1, e2], dim=-1)


def quat2euler(quat: torch.Tensor) -> torch.Tensor:
    return mat2euler(quat2mat(quat))
