"""Model builder of the PyTorch port: MjcfSpec -> Model
(`mj_envs_tpu/mjcf/builder.py`).

Host-side pass over numpy: the static collision-candidate pair list
(contype/conaffinity, weld/parent filtering, explicit <pair>/<exclude>),
contact slots per pair, the static constraint-row layout, and the qpos0
inverse weights, computed here (not loaded) as `_set_invweights_impl`
does: M^-1 at qpos0 from the port's own FK and CRB, in float64, then
cast to the model dtype.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..physics.model import (
    Model, ModelSpec,
    EFC_FRICTION_DOF, EFC_LIMIT_JOINT, EFC_LIMIT_TENDON, EFC_CONTACT,
    GEOM_PLANE, GEOM_MESH,
)
from ..physics.collision.driver import _SLOTS
from . import parser as P

_MAXCON: Dict[Tuple[int, int], int] = dict(_SLOTS)


def _contact_rows(condim: int) -> int:
    """Pyramidal-cone constraint rows per contact."""
    return 1 if condim == 1 else 2 * (condim - 1)


def _dyn_params(ga: P.Geom, gb: P.Geom):
    """MuJoCo dynamic pair parameter mixing (mj_contactParam); margins and
    gaps of the two geoms add."""
    if ga.priority != gb.priority:
        hi = ga if ga.priority > gb.priority else gb
        fr = hi.friction
        friction5 = np.array([fr[0], fr[0], fr[1], fr[2], fr[2]])
        return (hi.condim, friction5, ga.margin + gb.margin,
                ga.gap + gb.gap, hi.solref.copy(), hi.solimp.copy())
    condim = max(ga.condim, gb.condim)
    mix1, mix2 = ga.solmix, gb.solmix
    if mix1 >= 1e-15 and mix2 >= 1e-15:
        w1 = mix1 / (mix1 + mix2)
    elif mix1 < 1e-15 and mix2 < 1e-15:
        w1 = 0.5
    elif mix1 < 1e-15:
        w1 = 0.0
    else:
        w1 = 1.0
    w2 = 1.0 - w1
    if ga.solref[0] > 0 and gb.solref[0] > 0:
        solref = w1 * ga.solref + w2 * gb.solref
    else:
        solref = np.minimum(ga.solref, gb.solref)
    solimp = w1 * ga.solimp + w2 * gb.solimp
    fr = np.maximum(ga.friction, gb.friction)
    friction5 = np.array([fr[0], fr[0], fr[1], fr[2], fr[2]])
    return (condim, friction5, ga.margin + gb.margin, ga.gap + gb.gap,
            solref, solimp)


def _build_numpy(spec: P.MjcfSpec):
    """(ModelSpec, dict of float64/bool numpy leaves)."""
    # Mesh geoms are visual-only in this suite; mujoco numbers geoms,
    # sites and cameras grouped by body id.
    spec = copy.copy(spec)
    spec.geoms = sorted([g for g in spec.geoms if g.gtype != GEOM_MESH],
                        key=lambda g: g.body)
    spec.sites = sorted(spec.sites, key=lambda st: st.body)
    spec.cameras = sorted(spec.cameras, key=lambda c: c.body)

    nbody = len(spec.bodies)
    njnt = len(spec.joints)
    nv = nq = njnt
    ngeom = len(spec.geoms)
    ncam = len(spec.cameras)
    nten = len(spec.tendons)

    body_parentid = np.array([b.parent for b in spec.bodies], dtype=np.int32)
    body_parentid[0] = 0
    body_rootid = np.zeros(nbody, dtype=np.int32)
    for b in range(1, nbody):
        r = b
        while body_parentid[r] != 0:
            r = body_parentid[r]
        body_rootid[b] = r

    jnt_bodyid = np.array([j.body for j in spec.joints], dtype=np.int32)
    jnt_type = np.array([j.jtype for j in spec.joints], dtype=np.int32)
    jnt_limited = np.array([j.limited for j in spec.joints])

    has_joint = np.zeros(nbody, dtype=bool)
    for j in spec.joints:
        has_joint[j.body] = True
    body_weldid = np.zeros(nbody, dtype=np.int32)
    for b in range(1, nbody):
        body_weldid[b] = b if has_joint[b] else body_weldid[body_parentid[b]]

    def ancestors(b: int) -> List[int]:
        chain = []
        while b != 0:
            chain.append(b)
            b = int(body_parentid[b])
        return chain

    subtree_mask = np.eye(nbody, dtype=bool)
    for b in range(nbody - 1, 0, -1):
        subtree_mask[body_parentid[b]] |= subtree_mask[b]
    subtree_mask[0] = True

    body_dofmask = np.zeros((nbody, nv), dtype=bool)
    for b in range(1, nbody):
        anc = set(ancestors(b))
        for i in range(njnt):
            body_dofmask[b, i] = jnt_bodyid[i] in anc

    ancestor_mask = np.zeros((nv, nv), dtype=bool)
    for jdof in range(nv):
        for idof in range(jdof + 1):
            bi, bj = jnt_bodyid[idof], jnt_bodyid[jdof]
            ancestor_mask[idof, jdof] = bi == bj or body_dofmask[bj, idof]
    dof_strict_pred = np.zeros((nv, nv), dtype=bool)
    for jdof in range(nv):
        for idof in range(jdof):
            dof_strict_pred[jdof, idof] = ancestor_mask[idof, jdof]

    geom_bodyid = np.array([g.body for g in spec.geoms], dtype=np.int32)
    geom_type = np.array([g.gtype for g in spec.geoms], dtype=np.int32)

    # ---------------- collision pair enumeration ----------------
    name2geom = {g.name: i for i, g in enumerate(spec.geoms)
                 if g.name is not None}
    name2body = {b.name: i for i, b in enumerate(spec.bodies)
                 if b.name is not None}
    excl = set()
    for b1, b2 in spec.excludes:
        i1, i2 = name2body[b1], name2body[b2]
        excl.add((min(i1, i2), max(i1, i2)))

    explicit = set()
    pair_list = []
    for pr in spec.pairs:
        g1, g2 = name2geom[pr.geom1], name2geom[pr.geom2]
        if geom_type[g1] > geom_type[g2]:
            g1, g2 = g2, g1
        # Duplicate <pair> rows are kept, as mujoco keeps them.
        explicit.add((min(g1, g2), max(g1, g2)))
        pair_list.append((g1, g2, pr.condim, pr.friction.copy(), pr.margin,
                          pr.gap, pr.solref.copy(), pr.solimp.copy(), True))

    for g1 in range(ngeom):
        for g2 in range(g1 + 1, ngeom):
            if (g1, g2) in explicit:
                continue
            ga, gb = spec.geoms[g1], spec.geoms[g2]
            if ga.gtype == GEOM_PLANE and gb.gtype == GEOM_PLANE:
                continue
            if not ((ga.contype & gb.conaffinity)
                    or (gb.contype & ga.conaffinity)):
                continue
            b1, b2 = geom_bodyid[g1], geom_bodyid[g2]
            w1, w2 = body_weldid[b1], body_weldid[b2]
            if w1 == w2:
                continue
            # parent-child weld filter (parent == world allowed).
            wp1 = body_weldid[body_parentid[w1]] if w1 else -1
            wp2 = body_weldid[body_parentid[w2]] if w2 else -1
            if (w1 != 0 and wp1 == w2 and w2 != 0) or \
               (w2 != 0 and wp2 == w1 and w1 != 0):
                continue
            if (min(b1, b2), max(b1, b2)) in excl:
                continue
            a, b = (g1, g2) if geom_type[g1] <= geom_type[g2] else (g2, g1)
            pair_list.append((a, b) + _dyn_params(spec.geoms[a],
                                                  spec.geoms[b]) + (False,))

    # Order pairs by geom-type group (stable): each group's contact slots
    # are then contiguous.
    pair_list.sort(key=lambda p: (geom_type[p[0]], geom_type[p[1]]))
    npair = len(pair_list)
    pair_geom1 = np.array([p[0] for p in pair_list], dtype=np.int32)
    pair_geom2 = np.array([p[1] for p in pair_list], dtype=np.int32)
    pair_condim = np.array([p[2] for p in pair_list], dtype=np.int32)

    def stack(i, width):
        return (np.stack([p[i] for p in pair_list]) if npair
                else np.zeros((0, width)))

    # ---------------- contact slots ----------------
    con_pairid, con_geom1, con_geom2, con_condim = [], [], [], []
    for pid in range(npair):
        t1, t2 = geom_type[pair_geom1[pid]], geom_type[pair_geom2[pid]]
        for _ in range(_MAXCON[(min(t1, t2), max(t1, t2))]):
            con_pairid.append(pid)
            con_geom1.append(pair_geom1[pid])
            con_geom2.append(pair_geom2[pid])
            con_condim.append(pair_condim[pid])
    ncon_cap = len(con_pairid)
    con_condim = np.array(con_condim, dtype=np.int32)

    # ---------------- constraint row layout ----------------
    dof_frictionloss = np.array([j.frictionloss for j in spec.joints])
    ten_limited = np.array([t.limited for t in spec.tendons], dtype=bool)
    rows = [(EFC_FRICTION_DOF, i, -1, -1) for i in range(nv)
            if dof_frictionloss[i] > 0]
    rows += [(EFC_LIMIT_JOINT, j, -1, -1) for j in range(njnt)
             if jnt_limited[j]]
    rows += [(EFC_LIMIT_TENDON, t, -1, -1) for t in range(nten)
             if ten_limited[t]]
    rows += [(EFC_CONTACT, c, c, d) for c in range(ncon_cap)
             for d in range(_contact_rows(int(con_condim[c])))]
    efc = np.array(rows, dtype=np.int32).reshape(-1, 4)

    # ---------------- tendons / actuators / sensors ----------------
    name2jnt = {j.name: i for i, j in enumerate(spec.joints)
                if j.name is not None}
    ten_coef = np.zeros((nten, nv))
    for t, tend in enumerate(spec.tendons):
        for jname, coef in tend.joints:
            ten_coef[t, name2jnt[jname]] = coef
    name2act = {a.name: i for i, a in enumerate(spec.actuators)
                if a.name is not None}
    name2site = {st.name: i for i, st in enumerate(spec.sites)
                 if st.name is not None}
    sensors = []
    for adr, sn in enumerate(spec.sensors):
        obj = {"actuatorfrc": name2act, "touch": name2site}.get(
            sn.stype, name2jnt)[sn.obj]
        sensors.append((sn.stype, obj, adr, 1))

    names = {
        "body": name2body, "joint": name2jnt, "geom": name2geom,
        "site": name2site, "actuator": name2act,
        "sensor": {sn.name: i for i, sn in enumerate(spec.sensors)},
        "camera": {c.name: i for i, c in enumerate(spec.cameras)
                   if c.name is not None},
        "tendon": {t.name: i for i, t in enumerate(spec.tendons)
                   if t.name is not None},
    }
    i32 = lambda xs: np.array(xs, dtype=np.int32)
    mspec = ModelSpec(
        nq=nq, nv=nv, nu=len(spec.actuators), nbody=nbody, njnt=njnt,
        ngeom=ngeom, nsite=len(spec.sites), ncam=ncam, nten=nten,
        nsensor=len(spec.sensors), nsensordata=len(sensors), npair=npair,
        ncon_cap=ncon_cap, nefc_cap=len(efc),
        body_parentid=body_parentid, body_rootid=body_rootid,
        body_weldid=body_weldid,
        body_mocap=np.array([b.mocap for b in spec.bodies]),
        jnt_bodyid=jnt_bodyid, jnt_type=jnt_type, jnt_limited=jnt_limited,
        jnt_qposadr=np.arange(njnt, dtype=np.int32),
        geom_bodyid=geom_bodyid, geom_type=geom_type,
        geom_condim=i32([g.condim for g in spec.geoms]),
        geom_contype=i32([g.contype for g in spec.geoms]),
        geom_conaffinity=i32([g.conaffinity for g in spec.geoms]),
        geom_priority=i32([g.priority for g in spec.geoms]),
        site_bodyid=i32([st.body for st in spec.sites]),
        site_type=i32([st.stype for st in spec.sites]),
        cam_bodyid=i32([c.body for c in spec.cameras]),
        act_trnid=i32([name2jnt[a.joint] for a in spec.actuators]),
        act_biastype=i32([1 if a.biastype == "affine" else 0
                          for a in spec.actuators]),
        ten_limited=ten_limited,
        dof_hasfrictionloss=dof_frictionloss > 0,
        ancestor_mask=ancestor_mask, subtree_mask=subtree_mask,
        body_dofmask=body_dofmask, dof_strict_pred=dof_strict_pred,
        pair_geom1=pair_geom1, pair_geom2=pair_geom2,
        pair_condim=pair_condim,
        pair_explicit=np.array([p[8] for p in pair_list], dtype=bool),
        con_pairid=i32(con_pairid), con_geom1=i32(con_geom1),
        con_geom2=i32(con_geom2), con_condim=con_condim,
        efc_type=efc[:, 0].copy(), efc_id=efc[:, 1].copy(),
        efc_conadr=efc[:, 2].copy(), efc_condir=efc[:, 3].copy(),
        sensors=tuple(sensors), names=names,
        timestep=spec.option.timestep, gravity=spec.option.gravity.copy(),
        iterations=spec.option.iterations,
        noslip_iterations=spec.option.noslip_iterations,
        tolerance=spec.option.tolerance,
        noslip_tolerance=spec.option.noslip_tolerance,
        impratio=spec.option.impratio, model_name=spec.model_name,
    )

    def arr(rows_, width):
        return np.stack(rows_) if len(rows_) else np.zeros((0, width))

    bodies, joints, geoms, sites = (spec.bodies, spec.joints, spec.geoms,
                                    spec.sites)
    tendons, acts = spec.tendons, spec.actuators
    leaves = dict(
        qpos0=np.array([jt.ref for jt in joints]),
        body_pos=arr([b.pos for b in bodies], 3),
        body_quat=arr([b.quat for b in bodies], 4),
        body_ipos=arr([b.ipos for b in bodies], 3),
        body_iquat=arr([b.iquat for b in bodies], 4),
        body_mass=np.array([b.mass for b in bodies]),
        body_inertia=arr([b.inertia for b in bodies], 3),
        body_invweight0=np.zeros((nbody, 2)),
        jnt_pos=arr([jt.pos for jt in joints], 3),
        jnt_axis=arr([jt.axis for jt in joints], 3),
        jnt_range=arr([jt.range for jt in joints], 2),
        jnt_margin=np.array([jt.margin for jt in joints]),
        jnt_stiffness=np.array([jt.stiffness for jt in joints]),
        jnt_springref=np.array([jt.springref for jt in joints]),
        jnt_solref_lim=arr([jt.solref_lim for jt in joints], 2),
        jnt_solimp_lim=arr([jt.solimp_lim for jt in joints], 5),
        dof_damping=np.array([jt.damping for jt in joints]),
        dof_armature=np.array([jt.armature for jt in joints]),
        dof_frictionloss=dof_frictionloss,
        dof_solref_fri=arr([jt.solref_fri for jt in joints], 2),
        dof_solimp_fri=arr([jt.solimp_fri for jt in joints], 5),
        dof_invweight0=np.zeros(nv),
        geom_pos=arr([g.pos for g in geoms], 3),
        geom_quat=arr([g.quat for g in geoms], 4),
        geom_size=arr([g.size for g in geoms], 3),
        geom_rgba=arr([g.rgba for g in geoms], 4),
        site_pos=arr([st.pos for st in sites], 3),
        site_quat=arr([st.quat for st in sites], 4),
        site_size=arr([st.size for st in sites], 3),
        cam_pos=arr([c.pos for c in spec.cameras], 3),
        cam_quat=arr([c.quat for c in spec.cameras], 4),
        ten_coef=ten_coef,
        ten_range=arr([t.range for t in tendons], 2),
        ten_margin=np.array([t.margin for t in tendons]),
        ten_solref_lim=arr([t.solref_lim for t in tendons], 2),
        ten_solimp_lim=arr([t.solimp_lim for t in tendons], 5),
        ten_invweight0=np.zeros(nten),
        act_gainprm=arr([a.gainprm for a in acts], 10),
        act_biasprm=arr([a.biasprm for a in acts], 10),
        act_ctrlrange=arr([a.ctrlrange for a in acts], 2),
        act_forcerange=arr([a.forcerange for a in acts], 2),
        act_forcelimited=np.array([a.forcelimited for a in acts]),
        pair_friction=stack(3, 5),
        pair_margin=np.array([p[4] for p in pair_list]),
        pair_gap=np.array([p[5] for p in pair_list]),
        pair_solref=stack(6, 2),
        pair_solimp=stack(7, 5),
    )
    return mspec, leaves


def _invweights(model: Model):
    """dof/body/tendon inverse weights at qpos0 (mj_setConst) from M^-1,
    computed on `model` (float64 on the CPU)."""
    from ..physics import dynamics as D
    from ..physics import kinematics as K
    s = model.spec
    kin = K.kinematics(model, model.qpos0[None])
    Minv = torch.linalg.inv(D.crb(model, kin)[0])
    dof = torch.diagonal(Minv)
    jacp, jacr = K.point_jacobian(model, kin, kin.xipos,
                                  torch.arange(s.nbody))
    At = torch.einsum("bki,ij,blj->bkl", jacp[0], Minv, jacp[0])
    Ar = torch.einsum("bki,ij,blj->bkl", jacr[0], Minv, jacr[0])
    tr = lambda A: (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    body = torch.stack([tr(At), tr(Ar)], dim=-1)
    ten = torch.einsum("ti,ij,tj->t", model.ten_coef, Minv, model.ten_coef)
    return dof, body, ten


def build(spec: P.MjcfSpec, dtype=torch.float32, device="cuda") -> Model:
    """Model for `spec` in `dtype` on `device`."""
    mspec, leaves = _build_numpy(spec)
    m64 = Model.from_numpy(leaves, mspec, device="cpu", dtype=torch.float64)
    dof, body, ten = _invweights(m64)
    m64 = m64.replace(dof_invweight0=dof, body_invweight0=body,
                      ten_invweight0=ten)
    return m64.to(device=device, dtype=dtype)


def build_from_xml(path: str, dtype=torch.float32, device="cuda") -> Model:
    return build(P.parse_mjcf(path), dtype=dtype, device=device)
