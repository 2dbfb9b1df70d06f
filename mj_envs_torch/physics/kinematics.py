"""Forward kinematics and com-frame quantities, batch-first
(`mj_envs_tpu/physics/kinematics.py` `_kinematics_ref`).

The body tree is walked in Python (nbody <= ~33 in this suite); every
per-body op runs on all envs at once.  Subtree sums are matmuls against
static masks.  This is the configuration of the JAX package's batched
path off the TPU (`_kinematics_ref` under vmap); the fused FK kernel is
a later slice of the port.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import maths
from .model import Model, JNT_HINGE, JNT_SLIDE


class Kin(NamedTuple):
    xpos: torch.Tensor         # (B, nbody, 3)
    xquat: torch.Tensor        # (B, nbody, 4)
    xmat: torch.Tensor         # (B, nbody, 3, 3)
    xipos: torch.Tensor        # (B, nbody, 3)
    geom_xpos: torch.Tensor    # (B, ngeom, 3)
    geom_xmat: torch.Tensor    # (B, ngeom, 3, 3)
    site_xpos: torch.Tensor    # (B, nsite, 3)
    site_xmat: torch.Tensor    # (B, nsite, 3, 3)
    xanchor: torch.Tensor      # (B, njnt, 3)
    xaxis: torch.Tensor        # (B, njnt, 3)
    subtree_com: torch.Tensor  # (B, nbody, 3)
    root_com: torch.Tensor     # (B, nbody, 3)
    cdof: torch.Tensor         # (B, nv, 6) [angular; linear]
    cinert: torch.Tensor       # (B, nbody, 6, 6)


def kinematics(m: Model, qpos: torch.Tensor) -> Kin:
    """Forward kinematics for qpos (B, nq)."""
    s = m.spec
    dtype = qpos.dtype
    dev = qpos.device
    B = qpos.shape[0]

    xpos = [None] * s.nbody
    xquat = [None] * s.nbody
    xanchor = [None] * s.njnt
    xaxis = [None] * s.njnt
    xpos[0] = torch.zeros(B, 3, dtype=dtype, device=dev)
    xquat[0] = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype,
                            device=dev).expand(B, 4)

    jnts_of = [[] for _ in range(s.nbody)]
    for j in range(s.njnt):
        jnts_of[int(s.jnt_bodyid[j])].append(j)

    for b in range(1, s.nbody):
        p = int(s.body_parentid[b])
        pq = maths.quat_mul(xquat[p], m.body_quat[..., b, :])
        pp = xpos[p] + maths.quat_rot(xquat[p], m.body_pos[..., b, :])
        for j in jnts_of[b]:
            q_j = qpos[:, j]
            axis_l = m.jnt_axis[j]
            if int(s.jnt_type[j]) == JNT_SLIDE:
                pp = pp + maths.quat_rot(pq, axis_l * q_j[:, None])
            else:  # hinge: rotate about the anchor jnt_pos
                qrot = maths.axis_angle_to_quat(axis_l, q_j)
                anchor_w = pp + maths.quat_rot(pq, m.jnt_pos[j])
                pq = maths.quat_mul(pq, qrot)
                pq = maths.quat_normalize(pq)
                pp = anchor_w - maths.quat_rot(pq, m.jnt_pos[j])
            xanchor[j] = pp + maths.quat_rot(pq, m.jnt_pos[j])
            xaxis[j] = maths.quat_rot(pq, axis_l)
        xpos[b] = pp.expand(B, 3)
        xquat[b] = pq.expand(B, 4)

    xpos = torch.stack(xpos, dim=1)
    xquat = torch.stack(xquat, dim=1)
    xmat = maths.quat_to_mat(xquat)
    if s.njnt:
        xanchor = torch.stack(xanchor, dim=1)
        xaxis = torch.stack(xaxis, dim=1)
    else:
        xanchor = torch.zeros(B, 0, 3, dtype=dtype, device=dev)
        xaxis = torch.zeros(B, 0, 3, dtype=dtype, device=dev)

    xipos = xpos + maths.quat_rot(xquat, m.body_ipos)
    ximat = maths.quat_to_mat(maths.quat_mul(xquat, m.body_iquat))

    gb = torch.as_tensor(s.geom_bodyid, dtype=torch.long, device=dev)
    geom_xpos = xpos[:, gb] + maths.quat_rot(xquat[:, gb], m.geom_pos)
    geom_xmat = maths.quat_to_mat(maths.quat_mul(xquat[:, gb], m.geom_quat))
    sb = torch.as_tensor(s.site_bodyid, dtype=torch.long, device=dev)
    site_xpos = xpos[:, sb] + maths.quat_rot(xquat[:, sb], m.site_pos)
    site_xmat = maths.quat_to_mat(maths.quat_mul(xquat[:, sb], m.site_quat))

    # Subtree com (mass-weighted over static subtree masks).
    subtree_mask = torch.as_tensor(s.subtree_mask, dtype=dtype, device=dev)
    mass = m.body_mass
    wsum = (subtree_mask * mass[..., None, :]).sum(-1)           # (.., nbody)
    wpos = torch.matmul(subtree_mask, mass[..., :, None] * xipos)
    subtree_com = wpos / torch.clamp(wsum, min=1e-12)[..., None]
    rootid = torch.as_tensor(s.body_rootid, dtype=torch.long, device=dev)
    root_com = subtree_com[:, rootid]

    # cdof: spatial motion axis per dof at the tree-root com.
    jb = torch.as_tensor(s.jnt_bodyid, dtype=torch.long, device=dev)
    offset = root_com[:, jb] - xanchor
    is_hinge = torch.as_tensor(s.jnt_type == JNT_HINGE, device=dev)[:, None]
    ang = torch.where(is_hinge, xaxis, torch.zeros_like(xaxis))
    lin = torch.where(is_hinge, maths.cross(xaxis, offset), xaxis)
    cdof = torch.cat([ang, lin], dim=-1)

    # Spatial inertia per body at its tree-root com, world axes:
    # R diag(I) R^T as a broadcast-multiply-sum.
    tmp = ximat * m.body_inertia[..., None, :]
    inert_world = (tmp[..., :, None, :] * ximat[..., None, :, :]).sum(-1)
    cinert = maths.spatial_inertia(mass, inert_world, xipos - root_com)

    return Kin(xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos,
               geom_xpos=geom_xpos, geom_xmat=geom_xmat,
               site_xpos=site_xpos, site_xmat=site_xmat,
               xanchor=xanchor, xaxis=xaxis,
               subtree_com=subtree_com, root_com=root_com,
               cdof=cdof, cinert=cinert)


def point_jacobian(m: Model, kin: Kin, points: torch.Tensor,
                   bodyids: torch.Tensor):
    """Translational/rotational Jacobians of world points on bodies.

    points: (B, K, 3); bodyids: (B, K) or (K,) long.  Returns (jacp,
    jacr), each (B, K, 3, nv)."""
    s = m.spec
    dtype = points.dtype
    dev = points.device
    is_hinge = torch.as_tensor(s.jnt_type == JNT_HINGE, device=dev)
    rel = points[:, :, None, :] - kin.xanchor[:, None, :, :]   # (B,K,nv,3)
    xaxis = kin.xaxis[:, None, :, :]
    hinge_lin = maths.cross(xaxis, rel)
    lin = torch.where(is_hinge[:, None], hinge_lin, xaxis)
    ang = torch.where(is_hinge[:, None], xaxis, torch.zeros_like(xaxis))
    mask = torch.as_tensor(s.body_dofmask, dtype=dtype,
                           device=dev)[bodyids]                 # (.., K, nv)
    jacp = (lin * mask[..., None]).transpose(-1, -2)
    jacr = (ang * mask[..., None]).transpose(-1, -2)
    return jacp, jacr
