"""Constraint row assembly (`mj_envs_tpu/physics/constraint.py`,
`_make_rows_fast`, dense J): friction-loss, joint/tendon limits and
pyramidal contacts with MuJoCo's impedance / reference-acceleration /
regularizer semantics, batch-first.

Row layout is static: [dof friction | joint limits | tendon limits |
ncmax contacts x 6 facet slots], with per-env activity masks.  J is the
dense (B, nefc, nv) facet-expanded matrix (the JAX package's default
layout; its base-compressed `Jbase` option is not ported).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .model import Model
from .kinematics import Kin, point_jacobian
from .collision.driver import CompactContacts

MINVAL = 1e-15
MAXIMP = 0.9999
MINIMP = 0.0001


class Rows(NamedTuple):
    J: torch.Tensor        # (B, nefc, nv)
    aref: torch.Tensor     # (B, nefc)
    D: torch.Tensor        # (B, nefc) inverse regularizer (0 if inactive)
    R: torch.Tensor        # (B, nefc)
    floss: torch.Tensor    # (B, nefc) friction-loss bound (0: not friction)
    active: torch.Tensor   # (B, nefc) bool
    oneside: torch.Tensor  # (B, nefc) bool
    pos: torch.Tensor      # (B, nefc) violation (diagnostics)


def j_matvec(rows: Rows, x: torch.Tensor) -> torch.Tensor:
    """J @ x per env -> (B, nefc)."""
    return torch.matmul(rows.J, x[..., None])[..., 0]


def jt_matvec(rows: Rows, f: torch.Tensor) -> torch.Tensor:
    """J^T @ f per env -> (B, nv)."""
    return torch.matmul(rows.J.transpose(-1, -2), f[..., None])[..., 0]


def jtwj(rows: Rows, w: torch.Tensor) -> torch.Tensor:
    """J^T diag(w) J per env -> (B, nv, nv)."""
    return torch.matmul(rows.J.transpose(-1, -2) * w[..., None, :], rows.J)


def _impedance(solimp, pos_m):
    """MuJoCo impedance d(x), x = |pos - margin| / width."""
    dmin, dmax, width, mid, power = (solimp[..., i] for i in range(5))
    x = torch.clamp(pos_m.abs() / torch.clamp(width, min=MINVAL), 0.0, 1.0)
    y_lo = torch.pow(torch.clamp(x, min=1e-30), power) \
        / torch.pow(torch.clamp(mid, min=MINVAL), power - 1)
    y_hi = 1.0 - torch.pow(torch.clamp(1.0 - x, min=1e-30), power) \
        / torch.pow(torch.clamp(1.0 - mid, min=MINVAL), power - 1)
    y = torch.where(x <= mid, y_lo, y_hi)
    return torch.clamp(dmin + y * (dmax - dmin), MINIMP, MAXIMP)


def _kb(solref, solimp):
    """Stiffness/damping from solref (positive: time-constant form)."""
    dmax = solimp[..., 1]
    timeconst, dampratio = solref[..., 0], solref[..., 1]
    direct = solref[..., 0] <= 0
    k = torch.where(direct, -solref[..., 0],
                    1.0 / torch.clamp(dmax ** 2 * timeconst ** 2
                                      * dampratio ** 2, min=MINVAL))
    b = torch.where(direct, -solref[..., 1],
                    2.0 / torch.clamp(dmax * timeconst, min=MINVAL))
    return k, b


def _lim_rows(q, lo, hi, margin):
    dist_lo = q - lo
    dist_hi = hi - q
    lower = dist_lo < dist_hi
    dist = torch.where(lower, dist_lo, dist_hi)
    sgn = torch.where(lower, torch.ones_like(q), -torch.ones_like(q))
    return dist, sgn, dist < margin


def make_rows(m: Model, kin: Kin, qpos: torch.Tensor, qvel: torch.Tensor,
              con: CompactContacts) -> Rows:
    """`_make_rows_fast` with the dense facet-expanded J."""
    s = m.spec
    dtype, dev = qpos.dtype, qpos.device
    B, nv = qpos.shape
    Js, arefs, Rs, fls, actives, onesides, poss = [], [], [], [], [], [], []

    def idx(a):
        return torch.as_tensor(a, dtype=torch.long, device=dev)

    # ---- dof friction rows (always active) -------------------------------
    fr_dofs = np.nonzero(s.dof_hasfrictionloss)[0]
    if len(fr_dofs):
        nf = len(fr_dofs)
        fd = idx(fr_dofs)
        E = torch.zeros(nf, nv, dtype=dtype, device=dev)
        E[torch.arange(nf, device=dev), fd] = 1.0
        imp = _impedance(m.dof_solimp_fri[fd],
                         torch.zeros(nf, dtype=dtype, device=dev))
        k, b = _kb(m.dof_solref_fri[fd], m.dof_solimp_fri[fd])
        Js.append(E.expand(B, nf, nv))
        arefs.append(-b * qvel[:, fd])
        Rs.append(torch.clamp((1 - imp) / imp * m.dof_invweight0[fd],
                              min=MINVAL).expand(B, nf))
        fls.append(m.dof_frictionloss[fd].expand(B, nf))
        actives.append(torch.ones(B, nf, dtype=torch.bool, device=dev))
        onesides.append(torch.zeros(B, nf, dtype=torch.bool, device=dev))
        poss.append(torch.zeros(B, nf, dtype=dtype, device=dev))

    # ---- joint limit rows -------------------------------------------------
    lim_jnts = np.nonzero(s.jnt_limited)[0]
    if len(lim_jnts):
        nl = len(lim_jnts)
        lj = idx(lim_jnts)
        margin = m.jnt_margin[lj]
        dist, sgn, act = _lim_rows(qpos[:, lj], m.jnt_range[lj, 0],
                                   m.jnt_range[lj, 1], margin)
        E = torch.zeros(nl, nv, dtype=dtype, device=dev)
        E[torch.arange(nl, device=dev), lj] = 1.0
        imp = _impedance(m.jnt_solimp_lim[lj], dist - margin)
        k, b = _kb(m.jnt_solref_lim[lj], m.jnt_solimp_lim[lj])
        aref = -b * (sgn * qvel[:, lj]) - k * imp * (dist - margin)
        actf = act.to(dtype)
        Js.append(E * sgn[..., None] * actf[..., None])
        arefs.append(aref * actf)
        Rs.append(torch.clamp((1 - imp) / imp * m.dof_invweight0[lj],
                              min=MINVAL))
        fls.append(torch.zeros(B, nl, dtype=dtype, device=dev))
        actives.append(act)
        onesides.append(torch.ones(B, nl, dtype=torch.bool, device=dev))
        poss.append(dist)

    # ---- tendon limit rows -------------------------------------------------
    lim_tens = np.nonzero(s.ten_limited)[0]
    if len(lim_tens):
        nt = len(lim_tens)
        lt = idx(lim_tens)
        W = m.ten_coef[lt]                                    # (T, nv)
        margin = m.ten_margin[lt]
        dist, sgn, act = _lim_rows(qpos @ W.T, m.ten_range[lt, 0],
                                   m.ten_range[lt, 1], margin)
        Jt = sgn[..., None] * W                               # (B, T, nv)
        imp = _impedance(m.ten_solimp_lim[lt], dist - margin)
        k, b = _kb(m.ten_solref_lim[lt], m.ten_solimp_lim[lt])
        aref = -b * (Jt * qvel[:, None, :]).sum(-1) - k * imp * (dist - margin)
        actf = act.to(dtype)
        Js.append(Jt * actf[..., None])
        arefs.append(aref * actf)
        Rs.append(torch.clamp((1 - imp) / imp * m.ten_invweight0[lt],
                              min=MINVAL))
        fls.append(torch.zeros(B, nt, dtype=dtype, device=dev))
        actives.append(act)
        onesides.append(torch.ones(B, nt, dtype=torch.bool, device=dev))
        poss.append(dist)

    # ---- contact rows (ncmax x 6 facet slots) ------------------------------
    ncmax = con.dist.shape[1]
    gb = np.asarray(s.geom_bodyid)
    pair_bodies = idx(np.stack([gb[np.asarray(s.pair_geom1)],
                                gb[np.asarray(s.pair_geom2)]], axis=1))
    bp = pair_bodies[con.pairid]                              # (B, C, 2)
    jac1p, jac1r = point_jacobian(m, kin, con.pos, bp[..., 0])
    jac2p, jac2r = point_jacobian(m, kin, con.pos, bp[..., 1])
    djp = jac2p - jac1p                                       # (B, C, 3, nv)
    djr = jac2r - jac1r
    n, t1, t2 = con.frame[..., 0, :], con.frame[..., 1, :], con.frame[..., 2, :]
    Jn = (n[..., None] * djp).sum(-2)                         # (B, C, nv)
    Jt1 = (t1[..., None] * djp).sum(-2)
    Jt2 = (t2[..., None] * djp).sum(-2)
    Jtor = (n[..., None] * djr).sum(-2)

    invw_pair = (m.body_invweight0[pair_bodies[:, 0], 0]
                 + m.body_invweight0[pair_bodies[:, 1], 0])   # (P,)
    pid = con.pairid
    mu = m.pair_friction[pid]                                 # (B, C, 5)
    incmargin = m.pair_margin[pid] - m.pair_gap[pid]
    solref = m.pair_solref[pid]
    solimp = m.pair_solimp[pid]
    invw = invw_pair[pid]
    pos_m = con.dist - incmargin
    imp = _impedance(solimp, pos_m)                           # (B, C)
    k, b = _kb(solref, solimp)
    mu1 = mu[..., 0]
    # mj_diagApprox as the JAX package determined it against the oracle.
    diag_pyr = 2.0 * torch.clamp(mu1 * mu1 * (1.0 + mu1 * mu1), min=2.0) \
        * invw / s.impratio
    condim = con.condim
    is_normal_only = (condim == 1)[..., None]                 # (B, C, 1)
    nrows = torch.where(condim == 1, torch.ones_like(condim),
                        2 * (condim - 1))
    six = torch.arange(6, device=dev)
    row_live = (six < nrows[..., None]) & con.active[..., None]   # (B,C,6)

    # Base rows [Jn, mu1 Jt1, mu2 Jt2, mu3 Jtor] (direction d live iff
    # condim > d + 1), expanded to the 6 facets Jn +- mu_d Jd_d.
    actc = con.active.to(dtype)[..., None]
    dlive = ((torch.arange(3, device=dev) < (condim[..., None] - 1))
             & con.active[..., None]).to(dtype)               # (B, C, 3)
    Jdir = torch.stack([Jt1, Jt2, Jtor], dim=-2)              # (B, C, 3, nv)
    Jd = Jdir * (mu[..., 0:3] * dlive)[..., None]
    Jn_a = (Jn * actc)[..., None, :]                          # (B, C, 1, nv)
    plus = Jn_a + Jd
    minus = Jn_a - Jd
    facets = torch.stack([plus[..., 0, :], minus[..., 0, :], plus[..., 1, :],
                          minus[..., 1, :], plus[..., 2, :], minus[..., 2, :]],
                         dim=-2)                              # (B, C, 6, nv)
    livef = row_live.to(dtype)
    Js.append((facets * livef[..., None]).reshape(B, ncmax * 6, nv))

    vn = (Jn * qvel[:, None, :]).sum(-1)                      # (B, C)
    vd = (Jd * qvel[:, None, None, :]).sum(-1)                # (B, C, 3)
    vplus = vn[..., None] + vd
    vminus = vn[..., None] - vd
    vel = torch.stack([vplus[..., 0], vminus[..., 0], vplus[..., 1],
                       vminus[..., 1], vplus[..., 2], vminus[..., 2]], -1)
    aref_c = -b[..., None] * vel - (k * imp * pos_m)[..., None]
    diag = torch.where(is_normal_only, invw[..., None], diag_pyr[..., None])
    R_c = torch.clamp(((1 - imp) / imp)[..., None] * diag,
                      min=MINVAL).expand(B, ncmax, 6)
    arefs.append((aref_c * livef).reshape(B, -1))
    Rs.append(R_c.reshape(B, -1))
    fls.append(torch.zeros(B, ncmax * 6, dtype=dtype, device=dev))
    actives.append(row_live.reshape(B, -1))
    onesides.append(torch.ones(B, ncmax * 6, dtype=torch.bool, device=dev))
    poss.append(con.dist[..., None].expand(B, ncmax, 6).reshape(B, -1))

    cat = lambda xs: torch.cat([x.expand(B, *x.shape[-1:]) if x.dim() == 1
                                else x for x in xs], dim=1)
    J = torch.cat(Js, dim=1)
    aref = cat(arefs)
    R = cat(Rs)
    active = cat(actives)
    D = torch.where(active, 1.0 / R, torch.zeros_like(R))
    return Rows(J=J, aref=aref, D=D, R=R, floss=cat(fls), active=active,
                oneside=cat(onesides), pos=cat(poss))
