"""Forward dynamics pipeline and semi-implicit Euler integration
(`mj_envs_tpu/physics/pipeline.py`, float32 path), batch-first.

`step(model, data, ctrl)` has mj_step semantics: forward dynamics at the
current state (kinematics -> tendons/actuation -> smooth forces ->
collision -> constraints -> Newton -> noslip), then Euler with implicit
joint damping.  The returned Data holds the post-step (qpos, qvel) and
the *pre-step* kinematic caches, as MjData does after mj_step.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import actuation as A
from . import constraint as CN
from . import dynamics as D
from . import kernels
from . import kinematics as K
from . import solver as S
from .collision import driver as C
from .model import Data, Model


class ForwardOut(NamedTuple):
    kin: K.Kin
    M: torch.Tensor
    qfrc_bias: torch.Tensor
    qfrc_passive: torch.Tensor
    act: A.Actuation
    qacc_smooth: torch.Tensor
    contact_full: C.Contact
    contacts: C.CompactContacts
    rows: CN.Rows
    solve: S.SolveResult
    qacc: torch.Tensor
    sensordata: torch.Tensor
    contacts_clipped: torch.Tensor  # (B,) bool — more in-margin contacts
                                    # than the ncmax slots; compaction
                                    # dropped the overflow


def ncmax(spec) -> int:
    """Active-contact slot budget for the solver (the suite's scenes peak
    at ~10 simultaneous contacts)."""
    return getattr(spec, "ncon_active_cap", None) or min(spec.ncon_cap, 32)


def forward_core(m: Model, qpos, qvel, ctrl, qacc_warmstart,
                 qfrc_applied) -> ForwardOut:
    s = m.spec
    if qpos.dtype != torch.float32:
        raise NotImplementedError(
            "the port runs the float32 physics path only; the float64 "
            "oracle-parity path is a later slice")
    kin = K.kinematics(m, qpos)
    M = D.crb(m, kin)
    vel = D.com_velocity(m, kin, qvel)
    qfrc_bias = D.bias_force(m, kin, vel, qvel)
    qfrc_passive = D.passive_force(m, qpos, qvel)
    act = A.actuation(m, qpos, qvel, ctrl)
    qfrc_smooth = act.qfrc_actuator + qfrc_passive + qfrc_applied - qfrc_bias
    if s.noslip_iterations > 0:
        # Keep the factor of M for noslip's matrix right-hand side.
        qacc_smooth, M_fac = kernels.chol_solve_factor(M, qfrc_smooth)
    else:
        qacc_smooth, M_fac = kernels.chol_solve(M, qfrc_smooth), None

    nc = ncmax(s)
    contact_full, contacts = C.collide(m, kin, nc)
    rows = CN.make_rows(m, kin, qpos, qvel, contacts)
    solve = S.newton_solve(M, qacc_smooth, rows, qacc_warmstart,
                           iterations=s.iterations)
    if s.noslip_iterations > 0:
        nfl = int(np.sum(s.dof_hasfrictionloss))
        solve = S.noslip(M, rows, solve, nfl, nc, s.noslip_iterations,
                         M_fac=M_fac)
    sensordata = _sensors(m, kin, qpos, act, contacts, solve)
    clipped = contact_full.active.sum(-1) > nc
    return ForwardOut(kin=kin, M=M, qfrc_bias=qfrc_bias,
                      qfrc_passive=qfrc_passive, act=act,
                      qacc_smooth=qacc_smooth, contact_full=contact_full,
                      contacts=contacts, rows=rows, solve=solve,
                      qacc=solve.qacc, sensordata=sensordata,
                      contacts_clipped=clipped)


def _sensor_table(s, stype):
    pairs = [(obj, adr) for st, obj, adr, _ in s.sensors if st == stype]
    return (np.array([o for o, _ in pairs], dtype=np.int64),
            np.array([a for _, a in pairs], dtype=np.int64))


def _light_sensors(m: Model, qpos, act: A.Actuation) -> torch.Tensor:
    """jointpos and actuatorfrc sensors."""
    s = m.spec
    out = torch.zeros(qpos.shape[0], s.nsensordata, dtype=qpos.dtype,
                      device=qpos.device)
    for stype, src in (("jointpos", qpos), ("actuatorfrc",
                                             act.actuator_force)):
        objs, adrs = _sensor_table(s, stype)
        if len(objs):
            out[:, torch.as_tensor(adrs, device=qpos.device)] = \
                src[:, torch.as_tensor(objs, device=qpos.device)]
    return out


def _sensors(m: Model, kin: K.Kin, qpos, act: A.Actuation,
             contacts: C.CompactContacts,
             solve: S.SolveResult) -> torch.Tensor:
    """jointpos / actuatorfrc / touch sensors (the suite's full set)."""
    s = m.spec
    dev = qpos.device
    out = _light_sensors(m, qpos, act)
    sids, adrs = _sensor_table(s, "touch")
    if len(sids):
        B, nc = contacts.dist.shape
        sid = torch.as_tensor(sids, device=dev)
        # Per compacted contact: total normal force = sum of facet forces.
        normal_force = solve.efc_force[:, -nc * 6:].reshape(B, nc, 6).sum(-1)
        gb = torch.as_tensor(s.geom_bodyid, dtype=torch.long, device=dev)
        b1, b2 = gb[contacts.geom1], gb[contacts.geom2]            # (B, C)
        # (B, S, C, 3): contact positions in each touch site's frame.
        diff = contacts.pos[:, None, :, :] - kin.site_xpos[:, sid][:, :, None]
        rel = (kin.site_xmat[:, sid][:, :, None, :, :]
               * diff[..., :, None]).sum(-2)
        size = m.site_size[sid][None, :, None, :]                  # (1,S,1,3)
        in_sphere = (rel * rel).sum(-1) <= size[..., 0] ** 2
        in_cyl = (rel[..., 2].abs() <= size[..., 1]) & (
            rel[..., 0] ** 2 + rel[..., 1] ** 2 <= size[..., 0] ** 2)
        zc = torch.minimum(torch.maximum(rel[..., 2], -size[..., 1]),
                           size[..., 1])
        in_cap = (rel[..., 0] ** 2 + rel[..., 1] ** 2
                  + (rel[..., 2] - zc) ** 2) <= size[..., 0] ** 2
        in_box = (rel.abs() <= size).all(-1)
        stype = torch.as_tensor(s.site_type[sids], device=dev)[None, :, None]
        inside = torch.where(stype == 2, in_sphere,
                             torch.where(stype == 5, in_cyl,
                                         torch.where(stype == 3, in_cap,
                                                     in_box)))
        bodies = torch.as_tensor(s.site_bodyid[sids], dtype=torch.long,
                                 device=dev)[None, :, None]
        involves = (b1[:, None, :] == bodies) | (b2[:, None, :] == bodies)
        hit = inside & involves & contacts.active[:, None, :]
        vals = torch.where(hit, normal_force[:, None, :],
                           torch.zeros_like(normal_force[:, None, :])).sum(-1)
        out[:, torch.as_tensor(adrs, device=dev)] = vals
    return out


def _caches(kin: K.Kin, act: A.Actuation) -> dict:
    return dict(xpos=kin.xpos, xquat=kin.xquat, xipos=kin.xipos,
                geom_xpos=kin.geom_xpos, geom_xmat=kin.geom_xmat,
                site_xpos=kin.site_xpos, site_xmat=kin.site_xmat,
                subtree_com=kin.subtree_com, ten_length=act.ten_length,
                actuator_force=act.actuator_force)


def _write_caches(m: Model, d: Data, out: ForwardOut) -> Data:
    efc = torch.zeros_like(d.efc_force)
    efc[:, :out.solve.efc_force.shape[1]] = out.solve.efc_force
    return d.replace(
        sensordata=out.sensordata, efc_force=efc,
        ncon_active=out.contact_full.active.sum(-1).to(torch.int32),
        **_caches(out.kin, out.act))


def forward(m: Model, d: Data) -> Data:
    """Recompute all caches at (qpos, qvel, ctrl) — mj_forward."""
    out = forward_core(m, d.qpos, d.qvel, d.ctrl, d.qacc_warmstart,
                       d.qfrc_applied)
    return _write_caches(m, d, out).replace(qacc=out.qacc)


def forward_light(m: Model, d: Data) -> Data:
    """Reset-path forward: kinematic caches and the jointpos/actuatorfrc
    sensors, without collision or the constraint solve (no task obs reads
    contact forces at a fresh qpos0, qvel = 0 state)."""
    kin = K.kinematics(m, d.qpos)
    act = A.actuation(m, d.qpos, d.qvel, d.ctrl)
    return d.replace(sensordata=_light_sensors(m, d.qpos, act),
                     **_caches(kin, act))


def step(m: Model, d: Data, ctrl: torch.Tensor) -> Data:
    """mj_step: forward dynamics, then Euler with implicit joint damping:
    (M + h diag(B)) qacc' = M qacc."""
    h = float(m.spec.timestep)
    out = forward_core(m, d.qpos, d.qvel, ctrl, d.qacc_warmstart,
                       d.qfrc_applied)
    qfrc_total = torch.matmul(out.M, out.qacc[..., None])[..., 0]
    MhB = out.M + h * torch.diag(m.dof_damping)
    qacc_imp = kernels.chol_solve(MhB, qfrc_total)
    qvel_new = d.qvel + h * qacc_imp
    qpos_new = d.qpos + h * qvel_new
    d = _write_caches(m, d, out)
    return d.replace(qpos=qpos_new, qvel=qvel_new, ctrl=ctrl,
                     qacc=out.qacc, qacc_warmstart=out.solve.qacc,
                     time=d.time + h)
