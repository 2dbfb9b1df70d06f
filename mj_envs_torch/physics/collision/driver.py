"""Collision driver (`mj_envs_tpu/physics/collision/driver.py`): run the
narrowphase over all static candidate pairs, one batch per geom-type
group, and compact the active contacts into ncmax slots for the solver.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ... import trace
from ..model import (Model, GEOM_PLANE, GEOM_SPHERE, GEOM_CAPSULE,
                     GEOM_CYLINDER, GEOM_BOX)
from ..kinematics import Kin
from ..kernels import _on_card
from ..maths import cross, norm
from . import narrow_cuda
from . import narrowphase as NP

# Narrowphase function and contact slots per (type1, type2): all 14 pair
# types, so `mjcf/builder.py` lays out every task as the JAX package does.
_FNS = {
    (GEOM_PLANE, GEOM_SPHERE): (NP.plane_sphere, 1),
    (GEOM_PLANE, GEOM_CAPSULE): (NP.plane_capsule, 2),
    (GEOM_PLANE, GEOM_CYLINDER): (NP.plane_cylinder, 4),
    (GEOM_PLANE, GEOM_BOX): (NP.plane_box, 8),
    (GEOM_SPHERE, GEOM_SPHERE): (NP.sphere_sphere, 1),
    (GEOM_SPHERE, GEOM_CAPSULE): (NP.sphere_capsule, 1),
    (GEOM_SPHERE, GEOM_CYLINDER): (NP.sphere_cylinder, 1),
    (GEOM_SPHERE, GEOM_BOX): (NP.sphere_box, 1),
    (GEOM_CAPSULE, GEOM_CAPSULE): (NP.capsule_capsule, 2),
    (GEOM_CAPSULE, GEOM_CYLINDER): (NP.capsule_cylinder, 2),
    (GEOM_CAPSULE, GEOM_BOX): (NP.capsule_box, 2),
    (GEOM_CYLINDER, GEOM_CYLINDER): (NP.cylinder_cylinder, 4),
    (GEOM_CYLINDER, GEOM_BOX): (NP.cylinder_box, 4),
    (GEOM_BOX, GEOM_BOX): (NP.box_box, 24),
}
# Contact slots a pair contributes to the global buffer.
_SLOTS = {key: mc for key, (fn, mc) in _FNS.items()}
_TYPE_NAMES = {GEOM_PLANE: "plane", GEOM_SPHERE: "sphere",
               GEOM_CAPSULE: "capsule", GEOM_CYLINDER: "cylinder",
               GEOM_BOX: "box"}
# The tracer's span of each pair type's narrowphase, e.g. collide.capsule_box.
_SPANS = {(t1, t2): f"collide.{_TYPE_NAMES[t1]}_{_TYPE_NAMES[t2]}"
          for t1, t2 in _FNS}


class Contact(NamedTuple):
    """Static-slot contact buffer (B, S): slot -> candidate pair is fixed."""
    dist: torch.Tensor     # (B, S) signed distance
    pos: torch.Tensor      # (B, S, 3)
    nrm: torch.Tensor      # (B, S, 3) geom1 -> geom2
    active: torch.Tensor   # (B, S) bool — dist < margin


class CompactContacts(NamedTuple):
    """Fixed-capacity active contact set (B, ncmax), slot order kept."""
    pairid: torch.Tensor   # (B, C) long
    dist: torch.Tensor     # (B, C)
    pos: torch.Tensor      # (B, C, 3)
    frame: torch.Tensor    # (B, C, 3, 3) rows [n, t1, t2]
    active: torch.Tensor   # (B, C) bool
    geom1: torch.Tensor    # (B, C) long
    geom2: torch.Tensor    # (B, C) long
    condim: torch.Tensor   # (B, C) long


def _make_tangents(n: torch.Tensor):
    """Complete a right-handed frame from normals, as mju_makeFrame: seed
    +Z when |n_z| < 0.5 else +Y, orthogonalize, cross."""
    z_seed = (n[..., 2].abs() < 0.5)[..., None]
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype, device=n.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    e = torch.where(z_seed, ez, ey)
    t1 = e - n * (n * e).sum(-1, keepdim=True)
    t1 = t1 / torch.clamp(norm(t1), min=1e-12)[..., None]
    return t1, cross(n, t1)


def _groups(s):
    """Candidate pairs grouped by type pair, in pair order (mjcf/builder
    sorts the pair table by type group, so each group's slots are
    contiguous)."""
    gt = s.geom_type
    groups = []
    for pid in range(s.npair):
        key = (int(gt[s.pair_geom1[pid]]), int(gt[s.pair_geom2[pid]]))
        if groups and groups[-1][0] == key:
            groups[-1][1].append(pid)
        else:
            groups.append((key, [pid]))
    return groups


def plain_group(key, xpos, xmat, size, g1, g2, margin):
    """The plain pair function of type `key` over the (env, pair) rows of
    one group, geom ids g1, g2 (P,) and margins (P,), sizes (B, ngeom,
    3): (dist (B, P C), pos (B, P C, 3), nrm (B, P C, 3))."""
    B, P = xpos.shape[0], g1.shape[0]
    flat = lambda x: x.reshape((B * P,) + x.shape[2:])
    d, p, n = _FNS[key][0](flat(xpos[:, g1]), flat(xmat[:, g1]),
                           flat(size[:, g1]), flat(xpos[:, g2]),
                           flat(xmat[:, g2]), flat(size[:, g2]),
                           margin.expand(B, P).reshape(B * P))
    C = d.shape[-1]
    return (d.reshape(B, P * C), p.reshape(B, P * C, 3),
            n.reshape(B, P * C, 3))


def narrowphase_all(m: Model, kin: Kin) -> Contact:
    """Narrowphase over every candidate pair; one batched call per type
    group over (env, pair), results in slot order.  On the float32 card
    path a group of a type with a kernel (all but the sphere types) is
    one launch of it (`narrow_cuda`); the tracer counts the (env, pair)
    rows of each path (`collide.kernel_rows`, `collide.plain_rows`)."""
    s = m.spec
    dtype, dev = kin.geom_xpos.dtype, kin.geom_xpos.device
    B = kin.geom_xpos.shape[0]
    size = m.geom_size if m.geom_size.dim() == 3 else \
        m.geom_size.expand(B, -1, -1)
    chunks_d, chunks_p, chunks_n = [], [], []
    for key, pids in _groups(s):
        with trace.span(_SPANS[key]):
            P = len(pids)
            g1, g2, marg = narrow_cuda.group_tables(m, pids)
            if key in narrow_cuda.KERNELS and _on_card(
                    kin.geom_xpos, kin.geom_xmat, m.geom_size, m.pair_margin):
                trace.count("collide.kernel_rows", B * P)
                d, p, n = narrow_cuda.narrow_cuda(
                    key, kin.geom_xpos.contiguous(),
                    kin.geom_xmat.contiguous(), m.geom_size.contiguous(),
                    g1, g2, marg)
            else:
                trace.count("collide.plain_rows", B * P)
                d, p, n = plain_group(key, kin.geom_xpos, kin.geom_xmat,
                                      size, g1.long(), g2.long(), marg)
            chunks_d.append(d.to(dtype))
            chunks_p.append(p.to(dtype))
            chunks_n.append(n.to(dtype))
    dist = torch.cat(chunks_d, dim=1)
    pos = torch.cat(chunks_p, dim=1)
    nrm = torch.cat(chunks_n, dim=1)
    assert dist.shape[1] == s.ncon_cap, (dist.shape, s.ncon_cap)
    margin = m.pair_margin[torch.as_tensor(s.con_pairid, dtype=torch.long,
                                           device=dev)]
    return Contact(dist=dist, pos=pos, nrm=nrm, active=dist < margin)


def compact(m: Model, con: Contact, ncmax: int) -> CompactContacts:
    """Keep the first ncmax active slots, in slot order (rank by cumsum).
    Output slots past the active count hold zeros (dist = BIG, condim
    1); their frame is undefined and every consumer masks by `active`."""
    s = m.spec
    dev = con.dist.device
    B, S = con.dist.shape
    act = con.active
    rank = torch.cumsum(act.to(torch.int64), dim=1) - act.to(torch.int64)
    keep = act & (rank < ncmax)
    # Scatter each kept slot's index to its rank; the rest to a dump
    # column past the end.
    dest = torch.where(keep, rank, torch.full_like(rank, ncmax))
    src = torch.full((B, ncmax + 1), S, dtype=torch.int64, device=dev)
    src.scatter_(1, dest, torch.arange(S, device=dev).expand(B, S))
    idx = src[:, :ncmax]                                     # (B, C)
    valid = idx < S
    idx_c = torch.where(valid, idx, torch.zeros_like(idx))

    def take(x):
        return torch.gather(x, 1, idx_c.view((B, ncmax) + (1,) * (x.dim() - 2))
                            .expand((B, ncmax) + x.shape[2:]))

    v3 = valid[..., None]
    dist = torch.where(valid, take(con.dist),
                       torch.full_like(valid, NP.BIG, dtype=con.dist.dtype))
    pos = torch.where(v3, take(con.pos), torch.zeros(()).to(con.pos))
    nrm = torch.where(v3, take(con.nrm), torch.zeros(()).to(con.nrm))

    def table(a, fill):
        t = torch.as_tensor(np.asarray(a), dtype=torch.long, device=dev)[idx_c]
        return torch.where(valid, t, torch.full_like(t, fill))

    t1, t2 = _make_tangents(nrm)
    return CompactContacts(
        pairid=table(s.con_pairid, 0), dist=dist, pos=pos,
        frame=torch.stack([nrm, t1, t2], dim=-2), active=valid,
        geom1=table(s.con_geom1, 0), geom2=table(s.con_geom2, 0),
        condim=table(s.con_condim, 1))


def collide(m: Model, kin: Kin, ncmax: int):
    """Narrowphase + compaction: (full Contact, CompactContacts)."""
    con = narrowphase_all(m, kin)
    with trace.span("collide.compact"):
        return con, compact(m, con, ncmax)
