"""Forward kinematics and com-frame quantities, batch-first
(`mj_envs_tpu/physics/kinematics.py`).

`kinematics(m, qpos)` is the front end, with the rule of the solver
kernels (`kernels._on_card`): a CUDA float32 `qpos` launches the fused FK
kernel (`csrc/fk.cu`, the TPU's `fk_kernel._fk_kernel`), a CPU tensor runs
`kinematics_plain`, anything else raises.

`kinematics_plain` is `_kinematics_ref` batched: the body tree is walked
in Python (nbody <= ~33 in this suite) and every per-body op runs on all
envs at once; subtree sums are matmuls against static masks.
"""
from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch

from . import kernels, maths
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


def kinematics_plain(m: Model, qpos: torch.Tensor) -> Kin:
    """Forward kinematics for qpos (B, nq), plain PyTorch."""
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


# ---------------------------------------------------------------------------
# The FK kernel (csrc/fk.cu)
# ---------------------------------------------------------------------------

FK_WARPS = 4                 # fk.cu's kWarps: envs per block
FK_MAX_SMEM = 227 * 1024     # fk.cu's kMaxSmem: shared memory of a block

# Per ModelSpec, per device: (tree table, body_rootid as a long tensor).
_TABLES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def fk_field_shapes(s) -> dict:
    """The model fields the FK kernel reads, in fk.cu's order, with their
    shared shapes.  Each arrives shared, with this shape, or per env,
    with a leading env axis (a task's ModelVar); the kernel reads a
    shared field with batch stride 0."""
    nb, nj, ng, ns = s.nbody, s.njnt, s.ngeom, s.nsite
    return dict(body_pos=(nb, 3), body_quat=(nb, 4), body_ipos=(nb, 3),
                body_iquat=(nb, 4), jnt_pos=(nj, 3), jnt_axis=(nj, 3),
                geom_pos=(ng, 3), geom_quat=(ng, 4), site_pos=(ns, 3),
                site_quat=(ns, 4), body_mass=(nb,), body_inertia=(nb, 3))


def fk_smem_bytes(s, nlevel: int) -> int:
    """Shared memory of one FK block, as fk.cu's launch computes it: the
    tree table and FK_WARPS envs' slabs (qpos, the model fields, the
    body and joint poses, the output stage)."""
    nb, nj, ng, ns = s.nbody, s.njnt, s.ngeom, s.nsite
    ntab = 5 * nb + 1 + 4 * nj + ng + ns + nlevel + 1
    fields = 18 * nb + 6 * nj + 7 * ng + 7 * ns
    stage = max(14 * nb, 12 * ng, 12 * ns, 6 * nj)
    slab = s.nq + fields + 13 * nb + 6 * nj + stage
    return 4 * (ntab + FK_WARPS * slab)


def fk_table(s) -> np.ndarray:
    """The static body tree as fk.cu reads it (int32; layout in the
    source): the ids it walks, each body's subtree size, and the bodies
    in depth order with the offset of each level.  Raises for a model the
    kernel does not take."""
    parent = np.asarray(s.body_parentid, dtype=np.int64)
    depth = np.zeros(s.nbody, dtype=np.int64)
    for b in range(1, s.nbody):
        depth[b] = depth[parent[b]] + 1
    smem = fk_smem_bytes(s, int(depth.max()) + 1)
    if smem > FK_MAX_SMEM:
        raise ValueError(f"the FK kernel holds {FK_WARPS} envs per block in "
                         f"shared memory, at most {FK_MAX_SMEM} bytes; this "
                         f"model needs {smem}")
    jt = np.asarray(s.jnt_type)
    if s.nv != s.njnt or s.nq != s.njnt or not np.all(
            (jt == JNT_HINGE) | (jt == JNT_SLIDE)):
        raise ValueError("the FK kernel takes 1-dof hinge and slide joints "
                         "only (nq == nv == njnt)")
    jb = np.asarray(s.jnt_bodyid, dtype=np.int64)
    order = np.argsort(jb, kind="stable")     # a body's joints in j order
    adr = np.concatenate([[0], np.cumsum(np.bincount(jb, minlength=s.nbody))])
    by_depth = np.argsort(depth, kind="stable")
    level_adr = np.concatenate([[0], np.cumsum(np.bincount(depth))])
    # The kernel sums body b's subtree over the id range [b, b + size).
    mask = np.asarray(s.subtree_mask, dtype=bool)
    size = mask.sum(1)
    if any(not mask[b, b:b + size[b]].all() for b in range(s.nbody)):
        raise ValueError("the FK kernel takes bodies in depth-first order "
                         "(each subtree a contiguous range of ids)")
    return np.concatenate([
        parent, adr, order, jt, s.jnt_qposadr, jb, s.geom_bodyid,
        s.site_bodyid, s.body_rootid, size, by_depth,
        level_adr]).astype(np.int32)


def _tables(s, device):
    per_dev = _TABLES.setdefault(s, {})
    if device not in per_dev:
        per_dev[device] = (
            torch.as_tensor(fk_table(s), device=device),
            torch.as_tensor(s.body_rootid, dtype=torch.long, device=device))
    return per_dev[device]


def fk_cuda(m: Model, qpos: torch.Tensor) -> Kin:
    """K1: the whole FK of B envs in one launch; qpos (B, nq) float32."""
    import ctypes
    from ._build import load
    s = m.spec
    B = qpos.shape[0]
    kernels._check("qpos", qpos, (B, s.nq))
    tab, rootid = _tables(s, qpos.device)
    ptrs, strides = [], []
    for name, shape in fk_field_shapes(s).items():
        t = getattr(m, name)
        per_env = t.dim() == len(shape) + 1
        kernels._check(name, t, ((B,) + shape) if per_env else shape)
        ptrs.append(t.data_ptr())
        strides.append(int(np.prod(shape)) if per_env else 0)
    nb, nj = s.nbody, s.njnt

    def out(*shape):
        return torch.empty((B,) + shape, dtype=qpos.dtype, device=qpos.device)

    outs = [out(nb, 3), out(nb, 4), out(nb, 3, 3), out(nb, 3),
            out(s.ngeom, 3), out(s.ngeom, 3, 3), out(s.nsite, 3),
            out(s.nsite, 3, 3), out(nj, 3), out(nj, 3), out(nb, 3),
            out(nj, 6), out(nb, 6, 6)]
    err = load().fk(
        qpos.data_ptr(), tab.data_ptr(),
        (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_longlong * len(strides))(*strides),
        (ctypes.c_void_p * len(outs))(*(o.data_ptr() for o in outs)),
        B, s.nq, nb, nj, s.ngeom, s.nsite, tab.numel(),
        kernels._stream(qpos))
    kernels._raise_if(err, "fk")
    kernels.launches["fk"] += 1
    (xpos, xquat, xmat, xipos, geom_xpos, geom_xmat, site_xpos, site_xmat,
     xanchor, xaxis, subtree_com, cdof, cinert) = outs
    return Kin(xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos,
               geom_xpos=geom_xpos, geom_xmat=geom_xmat,
               site_xpos=site_xpos, site_xmat=site_xmat,
               xanchor=xanchor, xaxis=xaxis, subtree_com=subtree_com,
               root_com=subtree_com[:, rootid], cdof=cdof, cinert=cinert)


def kinematics(m: Model, qpos: torch.Tensor) -> Kin:
    """Forward kinematics for qpos (B, nq): the FK kernel for a CUDA
    float32 qpos, the plain version for a CPU one; anything else raises."""
    if kernels._on_card(qpos):
        m = m.replace(**{f: getattr(m, f).contiguous()
                         for f in fk_field_shapes(m.spec)})
        return fk_cuda(m, qpos.contiguous())
    return kinematics_plain(m, qpos)


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
