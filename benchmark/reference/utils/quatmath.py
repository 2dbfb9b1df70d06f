"""Rotation conversions (`mj_envs_tpu/utils/quatmath.py`), with the
reference's exact formulas: hammer-v0's observation embeds
quat2euler(body_xquat), pen-v0's reset draws its target orientation
through euler2quat, and the pixel envs place the model camera with
quat2mat.  Batched over any leading axes.
"""
from __future__ import annotations

import numpy as np
import torch

_EPS4 = float(np.finfo(np.float64).eps) * 4.0


def euler2quat(euler: torch.Tensor) -> torch.Tensor:
    """Intrinsic xyz Euler angles (..., 3) -> (..., 4) wxyz quaternion."""
    ai, aj, ak = euler[..., 2] / 2, -euler[..., 1] / 2, euler[..., 0] / 2
    si, sj, sk = torch.sin(ai), torch.sin(aj), torch.sin(ak)
    ci, cj, ck = torch.cos(ai), torch.cos(aj), torch.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    return torch.stack([cj * cc + sj * ss, cj * cs - sj * sc,
                        -(cj * ss + sj * cc), cj * sc - sj * cs], dim=-1)


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


def mulQuat(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (..., 4) wxyz quaternions."""
    return torch.stack([
        qa[..., 0] * qb[..., 0] - qa[..., 1] * qb[..., 1]
        - qa[..., 2] * qb[..., 2] - qa[..., 3] * qb[..., 3],
        qa[..., 0] * qb[..., 1] + qa[..., 1] * qb[..., 0]
        + qa[..., 2] * qb[..., 3] - qa[..., 3] * qb[..., 2],
        qa[..., 0] * qb[..., 2] - qa[..., 1] * qb[..., 3]
        + qa[..., 2] * qb[..., 0] + qa[..., 3] * qb[..., 1],
        qa[..., 0] * qb[..., 3] + qa[..., 1] * qb[..., 2]
        - qa[..., 2] * qb[..., 1] + qa[..., 3] * qb[..., 0],
    ], dim=-1)


def negQuat(quat: torch.Tensor) -> torch.Tensor:
    """The conjugate (w, -x, -y, -z)."""
    sign = torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=quat.dtype,
                        device=quat.device)
    return quat * sign


def quat2Vel(quat: torch.Tensor, dt: float = 1.0):
    """-> (speed (...,), axis (..., 3)) of the rotation `quat` over `dt`."""
    axis = quat[..., 1:]
    sin_a_2 = torch.sqrt((axis ** 2).sum(-1))
    axis = axis / (sin_a_2[..., None] + 1e-8)
    speed = 2 * torch.atan2(sin_a_2, quat[..., 0]) / dt
    return speed, axis


def quatDiff2Vel(quat1: torch.Tensor, quat2: torch.Tensor, dt: float):
    return quat2Vel(mulQuat(quat2, negQuat(quat1)), dt)


def axis_angle2quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    c = torch.cos(angle / 2)[..., None]
    s = torch.sin(angle / 2)[..., None]
    return torch.cat([c, s * axis], dim=-1)


def mat2quat(mat: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) wxyz quaternion: the
    eigenvector of the largest eigenvalue of the symmetric 4x4 K matrix,
    with w made non-negative (the reference's algorithm, batched through
    `torch.linalg.eigh`, whose eigenvalues ascend)."""
    Qxx, Qyx, Qzx = mat[..., 0, 0], mat[..., 0, 1], mat[..., 0, 2]
    Qxy, Qyy, Qzy = mat[..., 1, 0], mat[..., 1, 1], mat[..., 1, 2]
    Qxz, Qyz, Qzz = mat[..., 2, 0], mat[..., 2, 1], mat[..., 2, 2]
    K = torch.stack([
        torch.stack([Qxx - Qyy - Qzz, Qyx + Qxy, Qzx + Qxz, Qyz - Qzy], -1),
        torch.stack([Qyx + Qxy, Qyy - Qxx - Qzz, Qzy + Qyz, Qzx - Qxz], -1),
        torch.stack([Qzx + Qxz, Qzy + Qyz, Qzz - Qxx - Qyy, Qxy - Qyx], -1),
        torch.stack([Qyz - Qzy, Qzx - Qxz, Qxy - Qyx, Qxx + Qyy + Qzz], -1),
    ], dim=-2) / 3.0
    v = torch.linalg.eigh(K)[1][..., -1]
    q = torch.stack([v[..., 3], v[..., 0], v[..., 1], v[..., 2]], dim=-1)
    return torch.where(q[..., 0:1] < 0, -q, q)


def euler2mat(euler: torch.Tensor) -> torch.Tensor:
    """Euler angles (..., 3) -> (..., 3, 3) (the reference's formula)."""
    ai, aj, ak = -euler[..., 2], -euler[..., 1], -euler[..., 0]
    si, sj, sk = torch.sin(ai), torch.sin(aj), torch.sin(ak)
    ci, cj, ck = torch.cos(ai), torch.cos(aj), torch.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    row0 = torch.stack([cj * ci, cj * si, -sj], dim=-1)
    row1 = torch.stack([sj * cs - sc, sj * ss + cc, cj * sk], dim=-1)
    row2 = torch.stack([sj * cc + ss, sj * sc - cs, cj * ck], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)
