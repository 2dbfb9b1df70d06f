"""Quaternion and spatial-vector algebra (`mj_envs_tpu/physics/maths.py`).

MuJoCo conventions: quaternions are (w, x, y, z); 6D spatial vectors are
[angular(3); linear(3)] in world axes at the tree's com-frame origin.
Every function broadcasts over leading axes and keeps the input dtype.
"""
from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis (broadcasting leading axes)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by,
                        az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, as sqrt(sum(v*v))."""
    return torch.sqrt((v * v).sum(-1))


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b for (..., 4) wxyz quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_normalize(q: torch.Tensor, eps: float = 1e-15) -> torch.Tensor:
    n = norm(q)[..., None]
    return q / torch.clamp(n, min=eps)


def quat_rot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q: v + 2(qw (qv x v) + qv x (qv x v))."""
    qw = q[..., :1]
    qv = q[..., 1:]
    uv = cross(qv, v)
    uuv = cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor
                       ) -> torch.Tensor:
    """Unit axis (..., 3), angle (...) -> (..., 4) quaternion."""
    half = 0.5 * angle
    c = torch.cos(half)[..., None]
    sa = torch.sin(half)[..., None] * axis
    return torch.cat([c.expand(sa.shape[:-1] + (1,)), sa], dim=-1)


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Motion-space cross product v x m (mju_crossMotion)."""
    va, vl = v[..., :3], v[..., 3:]
    ma, ml = m[..., :3], m[..., 3:]
    return torch.cat([cross(va, ma), cross(va, ml) + cross(vl, ma)], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Force-space cross product v x* f (mju_crossForce)."""
    va, vl = v[..., :3], v[..., 3:]
    fa, fl = f[..., :3], f[..., 3:]
    return torch.cat([cross(va, fa) + cross(vl, fl), cross(va, fl)], dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        z, -v[..., 2], v[..., 1],
        v[..., 2], z, -v[..., 0],
        -v[..., 1], v[..., 0], z,
    ], dim=-1).reshape(v.shape[:-1] + (3, 3))


def spatial_inertia(mass: torch.Tensor, inertia_mat: torch.Tensor,
                    offset: torch.Tensor) -> torch.Tensor:
    """6x6 spatial inertia about a point displaced by `offset` (com -
    point) from the body com; [angular; linear] ordering."""
    d = offset
    m = mass[..., None, None]
    eye = torch.eye(3, dtype=inertia_mat.dtype, device=inertia_mat.device)
    ddT = d[..., :, None] * d[..., None, :]
    dd = (d * d).sum(-1)[..., None, None]
    I_shift = inertia_mat + m * (dd * eye - ddT)
    skew_d = skew(d)
    top = torch.cat([I_shift, m * skew_d], dim=-1)
    bot = torch.cat([m * skew_d.transpose(-1, -2),
                     m * eye + torch.zeros_like(I_shift)], dim=-1)
    return torch.cat([top, bot], dim=-2)
