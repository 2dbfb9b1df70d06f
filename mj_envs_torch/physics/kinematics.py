"""Forward kinematics and com-frame quantities, batch-first
(`mj_envs_tpu/physics/kinematics.py`).

`kinematics(m, qpos)` is the front end.  For a float32 `qpos` it reads
the JAX package's FK options on every call (`fk_impl`):

* ``MJE_FK_IMPL=pallas`` (the default): the fused FK kernel
  (`csrc/fk.cu`, the TPU's `fk_kernel._fk_kernel`) on a CUDA tensor,
  `kinematics_plain` on a CPU one; ``MJE_NO_FK_KERNEL=1`` turns it into
  ``ref``;
* ``MJE_FK_IMPL=parallel``: `kinematics_parallel`, the pointer-doubling
  FK, in plain torch ops on either device;
* ``MJE_FK_IMPL=ref`` (or any other value): `kinematics_plain`.

Any other dtype runs `kinematics_plain` and launches nothing (the
float64 oracle-parity path; the rule of `kernels._on_card`, which
raises for a dtype the card's path does not take).

`kinematics_plain` is `_kinematics_ref` batched: the body tree is walked
in Python (nbody <= ~33 in this suite) and every per-body op runs on all
envs at once; subtree sums are matmuls against static masks.
"""
from __future__ import annotations

import os
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
    if s.njnt:
        xanchor = torch.stack(xanchor, dim=1)
        xaxis = torch.stack(xaxis, dim=1)
    else:
        xanchor = torch.zeros(B, 0, 3, dtype=dtype, device=dev)
        xaxis = torch.zeros(B, 0, 3, dtype=dtype, device=dev)
    return _frames(m, xpos, xquat, xanchor, xaxis)


def _frames(m: Model, xpos, xquat, xanchor, xaxis) -> Kin:
    """Everything FK derives from the body and joint poses: frames,
    inertial, geom and site poses, subtree com, cdof and cinert."""
    s = m.spec
    dtype, dev = xpos.dtype, xpos.device
    xmat = maths.quat_to_mat(xquat)
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
    # R diag(I) R^T, a broadcast-multiply-sum in float32 and the JAX
    # package's einsum in float64 (its oracle-parity op set).
    if dtype == torch.float64:
        inert_world = torch.einsum(
            "...bij,...bj,...bkj->...bik", ximat,
            m.body_inertia.expand(ximat.shape[:-1]), ximat)
    else:
        tmp = ximat * m.body_inertia[..., None, :]
        inert_world = (tmp[..., :, None, :]
                       * ximat[..., None, :, :]).sum(-1)
    cinert = maths.spatial_inertia(mass, inert_world, xipos - root_com)

    return Kin(xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos,
               geom_xpos=geom_xpos, geom_xmat=geom_xmat,
               site_xpos=site_xpos, site_xmat=site_xmat,
               xanchor=xanchor, xaxis=xaxis,
               subtree_com=subtree_com, root_com=root_com,
               cdof=cdof, cinert=cinert)


# ---------------------------------------------------------------------------
# Pointer-doubling FK (MJE_FK_IMPL=parallel)
# ---------------------------------------------------------------------------

# Per ModelSpec: the static tables of `kinematics_parallel`.
_PAR_TABLES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def fk_parallel_tables(s):
    """(parent, jslot, maxj, body_of_jnt, slot_of_jnt, anc): each body's
    joint slots (njnt marks an empty one), each joint's body and slot,
    and the 2^k-ancestor tables of the body tree (`_fk_parallel_static`
    of the JAX package)."""
    if s in _PAR_TABLES:
        return _PAR_TABLES[s]
    parent = np.asarray(s.body_parentid, dtype=np.int64).copy()
    nbody, njnt = int(s.nbody), int(s.njnt)
    jnts_of = [[] for _ in range(nbody)]
    for j in range(njnt):
        jnts_of[int(s.jnt_bodyid[j])].append(j)
    maxj = max((len(x) for x in jnts_of), default=0)
    jslot = np.full((nbody, max(1, maxj)), njnt, dtype=np.int64)
    slot_of_jnt = np.zeros(njnt, dtype=np.int64)
    for b, js in enumerate(jnts_of):
        for t, j in enumerate(js):
            jslot[b, t] = j
            slot_of_jnt[j] = t
    body_of_jnt = np.asarray(s.jnt_bodyid, dtype=np.int64)
    depth = np.zeros(nbody, dtype=np.int64)
    for b in range(1, nbody):
        depth[b] = depth[parent[b]] + 1
    max_depth = int(depth.max()) if nbody > 1 else 1
    rounds = 0
    while (1 << rounds) < max_depth:
        rounds += 1
    anc = []
    a = parent.copy()
    a[0] = 0
    for _ in range(rounds):
        anc.append(a.copy())
        a = a[a]
    out = (parent, jslot, maxj, body_of_jnt, slot_of_jnt, tuple(anc))
    _PAR_TABLES[s] = out
    return out


def kinematics_parallel(m: Model, qpos: torch.Tensor) -> Kin:
    """Forward kinematics for qpos (B, nq) with a log-depth dependency
    graph (`_kinematics_parallel` of the JAX package), plain PyTorch:
    (a) every joint's local transform at once; (b) each body's joint
    chain folded in `maxj` masked rounds; (c) the body tree composed by
    pointer doubling over the static 2^k-ancestor tables (4 rounds on
    the Adroit trees).  The same formulas as `kinematics_plain`,
    associated differently, with one quaternion normalization at the
    end instead of one per hinge: float32 rounding apart from it."""
    s = m.spec
    dtype, dev = qpos.dtype, qpos.device
    B = qpos.shape[0]
    parent, jslot, maxj, body_of_jnt, slot_of_jnt, anc = \
        fk_parallel_tables(s)
    njnt, nbody = s.njnt, s.nbody

    def idx(a):
        return torch.as_tensor(a, dtype=torch.long, device=dev)

    # (a) per-joint local transforms (parent frame -> after the joint):
    # a hinge about its anchor jnt_pos, p = jp - R(rq) jp; a slide
    # p = axis q.  A sentinel identity row stands for an empty slot.
    qj = qpos[:, idx(s.jnt_qposadr)]                          # (B, njnt)
    axis, jp = m.jnt_axis, m.jnt_pos
    is_slide = torch.as_tensor(s.jnt_type == JNT_SLIDE, device=dev)[:, None]
    rq = maths.axis_angle_to_quat(axis, qj)                   # (B, njnt, 4)
    ident_q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype,
                           device=dev).expand(B, njnt + 1, 4)
    Jq = torch.where(is_slide, ident_q[:, :njnt], rq)
    Jp = torch.where(is_slide, axis * qj[..., None],
                     jp - maths.quat_rot(rq, jp))
    Jq = torch.cat([Jq, ident_q[:, :1]], dim=1)
    Jp = torch.cat([Jp, torch.zeros(B, 1, 3, dtype=dtype, device=dev)],
                   dim=1)

    # (b) in-body chains: L_b = offset_b . J_1 . ... . J_k.
    Lq = m.body_quat.expand(B, nbody, 4)
    Lp = m.body_pos.expand(B, nbody, 3)
    round_q, round_p = [], []
    for t in range(maxj):
        slot = jslot[:, t]
        newq = maths.quat_mul(Lq, Jq[:, idx(slot)])
        newp = Lp + maths.quat_rot(Lq, Jp[:, idx(slot)])
        round_q.append(newq)
        round_p.append(newp)
        has = torch.as_tensor((slot < njnt)[:, None], device=dev)
        Lq = torch.where(has, newq, Lq)
        Lp = torch.where(has, newp, Lp)

    # (c) the tree prefix by pointer doubling.
    Gq, Gp = Lq, Lp
    for a in anc:
        aj = idx(a)
        pq, pp = Gq[:, aj], Gp[:, aj]
        Gq = maths.quat_mul(pq, Gq)
        Gp = pp + maths.quat_rot(pq, Gp)
    xquat = maths.quat_normalize(Gq)
    xpos = Gp

    # Joint anchors and axes in world: the parent body's frame composed
    # with the joint's within-body prefix (including the joint).
    if njnt:
        sj, bj = idx(slot_of_jnt), idx(body_of_jnt)
        Aq = torch.stack(round_q, dim=1)[:, sj, bj]           # (B, njnt, 4)
        Ap = torch.stack(round_p, dim=1)[:, sj, bj]
        pb = idx(parent[body_of_jnt])
        Wq, Wp = xquat[:, pb], xpos[:, pb]
        WAq = maths.quat_normalize(maths.quat_mul(Wq, Aq))
        WAp = Wp + maths.quat_rot(Wq, Ap)
        xanchor = WAp + maths.quat_rot(WAq, jp)
        xaxis = maths.quat_rot(WAq, axis)
    else:
        xanchor = torch.zeros(B, 0, 3, dtype=dtype, device=dev)
        xaxis = torch.zeros(B, 0, 3, dtype=dtype, device=dev)
    return _frames(m, xpos, xquat, xanchor, xaxis)


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


def fk_impl(dtype=torch.float32) -> str:
    """The FK that `kinematics` runs for `dtype`, read from the
    environment as the JAX package reads it: MJE_FK_IMPL (pallas,
    parallel or ref; default pallas), MJE_NO_FK_KERNEL=1 turning pallas
    into ref; any dtype but float32 runs ref."""
    impl = os.environ.get("MJE_FK_IMPL", "pallas")
    if dtype != torch.float32:
        return "ref"
    if impl == "pallas" and os.environ.get("MJE_NO_FK_KERNEL", "0") == "1":
        return "ref"
    return impl


def kinematics(m: Model, qpos: torch.Tensor) -> Kin:
    """Forward kinematics for qpos (B, nq), as `fk_impl` selects: the FK
    kernel for a CUDA float32 qpos under pallas, `kinematics_parallel`
    under parallel, the plain version otherwise; a dtype the card's path
    does not take raises there (`kernels._on_card`)."""
    on_card = kernels._on_card(qpos)
    impl = fk_impl(qpos.dtype)
    if impl == "parallel":
        return kinematics_parallel(m, qpos)
    if impl == "pallas" and on_card:
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
