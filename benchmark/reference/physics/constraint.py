"""Constraint row assembly (`mj_envs_tpu/physics/constraint.py`):
friction-loss, joint/tendon limits and pyramidal contacts with MuJoCo's
impedance / reference-acceleration / regularizer semantics, batch-first.

Row layout is static: [dof friction | joint limits | tendon limits |
ncmax contacts x 6 facet slots], with per-env activity masks.

`make_rows` dispatches as the JAX package does: float64 (the
oracle-parity path) runs `make_rows_ref` (`_make_rows_ref`: dense J,
inactive rows zeroed); float32 runs `_make_rows_fast` with the dense
facet-expanded J by default, or, with ``MJE_JBASE=1`` (read on every
call), the base-compressed layout: J holds only the non-contact rows and
`Jbase` (B, ncmax*4, nv) holds per contact [Jn, mu1 Jt1, mu2 Jt2,
mu3 Jtor], from which `j_matvec`, `jt_matvec`, `jtwj` and `expand_J`
rebuild the six facets Jn +- mu_d Jd_d on the fly.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .model import Model
from .kinematics import Kin, point_jacobian
from .collision.driver import CompactContacts

MINVAL = 1e-15
MAXIMP = 0.9999
MINIMP = 0.0001


class Rows(NamedTuple):
    """Constraint rows.  The per-row vectors are always the full
    facet-expanded nefc; J is dense (B, nefc, nv) when `Jbase` is None,
    else only the non-contact rows (B, nother, nv)."""
    J: torch.Tensor        # (B, nefc, nv) or (B, nother, nv)
    aref: torch.Tensor     # (B, nefc)
    D: torch.Tensor        # (B, nefc) inverse regularizer (0 if inactive)
    R: torch.Tensor        # (B, nefc)
    floss: torch.Tensor    # (B, nefc) friction-loss bound (0: not friction)
    active: torch.Tensor   # (B, nefc) bool
    oneside: torch.Tensor  # (B, nefc) bool
    pos: torch.Tensor      # (B, nefc) violation (diagnostics)
    Jbase: Optional[torch.Tensor] = None   # (B, ncmax*4, nv) or None


def jbase_enabled() -> bool:
    """The dense contact rows: the port's default, read from no option."""
    return False


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(A, x[..., None])[..., 0]


def _facets(pn: torch.Tensor, pd: torch.Tensor) -> torch.Tensor:
    """(..., 6) facet values [pn + pd0, pn - pd0, pn + pd1, ...] from a
    normal value pn (..., 1) and three direction values pd (..., 3)."""
    plus, minus = pn + pd, pn - pd
    return torch.stack([plus[..., 0], minus[..., 0], plus[..., 1],
                        minus[..., 1], plus[..., 2], minus[..., 2]], dim=-1)


def j_matvec(rows: Rows, x: torch.Tensor) -> torch.Tensor:
    """J @ x per env over the full facet-expanded rows -> (B, nefc)."""
    if rows.Jbase is None:
        return _mv(rows.J, x)
    B = x.shape[0]
    base = _mv(rows.Jbase, x).reshape(B, -1, 4)               # (B, C, 4)
    exp = _facets(base[..., 0:1], base[..., 1:4])             # (B, C, 6)
    return torch.cat([_mv(rows.J, x), exp.reshape(B, -1)], dim=1)


def jt_matvec(rows: Rows, f: torch.Tensor) -> torch.Tensor:
    """J^T @ f per env for facet-expanded f (B, nefc) -> (B, nv)."""
    if rows.Jbase is None:
        return _mv(rows.J.transpose(-1, -2), f)
    B, nother = f.shape[0], rows.J.shape[1]
    fc = f[:, nother:].reshape(B, -1, 6)                      # (B, C, 6)
    fsum = (fc[..., 0] + fc[..., 1] + fc[..., 2] + fc[..., 3]
            + fc[..., 4] + fc[..., 5])
    coef = torch.stack([fsum, fc[..., 0] - fc[..., 1],
                        fc[..., 2] - fc[..., 3],
                        fc[..., 4] - fc[..., 5]], dim=-1)     # (B, C, 4)
    return _mv(rows.J.transpose(-1, -2), f[:, :nother]) \
        + _mv(rows.Jbase.transpose(-1, -2), coef.reshape(B, -1))


def jtwj(rows: Rows, w: torch.Tensor) -> torch.Tensor:
    """J^T diag(w) J per env for facet-expanded w -> (B, nv, nv).  With
    Jbase, each contact's block is Jb^T S Jb with a symmetric 4x4
    coupling S (S00 = sum w, S0d = Sd0 = w+_d - w-_d, Sdd = w+_d +
    w-_d), applied as row combinations before one contraction."""
    if rows.Jbase is None:
        return torch.matmul(rows.J.transpose(-1, -2) * w[..., None, :],
                            rows.J)
    B, nother, nv = rows.J.shape
    wc = w[:, nother:].reshape(B, -1, 6)                      # (B, C, 6)
    s0 = (wc[..., 0] + wc[..., 1] + wc[..., 2] + wc[..., 3]
          + wc[..., 4] + wc[..., 5])                          # (B, C)
    sd = torch.stack([wc[..., 0] + wc[..., 1], wc[..., 2] + wc[..., 3],
                      wc[..., 4] + wc[..., 5]], dim=-1)       # (B, C, 3)
    dd = torch.stack([wc[..., 0] - wc[..., 1], wc[..., 2] - wc[..., 3],
                      wc[..., 4] - wc[..., 5]], dim=-1)       # (B, C, 3)
    Jb = rows.Jbase.reshape(B, -1, 4, nv)
    Jn, Jd = Jb[:, :, 0], Jb[:, :, 1:4]                       # (B,C,nv), (B,C,3,nv)
    Y0 = s0[..., None] * Jn + (dd[..., None] * Jd).sum(2)
    Yd = dd[..., None] * Jn[:, :, None, :] + sd[..., None] * Jd
    Y = torch.cat([Y0[:, :, None, :], Yd], dim=2)             # (B, C, 4, nv)
    return torch.matmul(rows.J.transpose(-1, -2)
                        * w[:, None, :nother], rows.J) \
        + torch.matmul(rows.Jbase.transpose(-1, -2), Y.reshape(B, -1, nv))


def expand_J(rows: Rows) -> torch.Tensor:
    """The full dense (B, nefc, nv) J (dead facet slots zero rows)."""
    if rows.Jbase is None:
        return rows.J
    B, nother, nv = rows.J.shape
    Jb = rows.Jbase.reshape(B, -1, 4, nv)
    facets = _facets(Jb[:, :, 0:1].transpose(-1, -2),
                     Jb[:, :, 1:4].transpose(-1, -2))         # (B, C, nv, 6)
    facets = facets.transpose(-1, -2)                         # (B, C, 6, nv)
    live = rows.active[:, nother:].reshape(B, -1, 6).to(rows.J.dtype)
    return torch.cat([rows.J, (facets * live[..., None]).reshape(B, -1, nv)],
                     dim=1)


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


def _other_rows(m: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                masked: bool):
    """The dof friction, joint limit and tendon limit rows, as lists of
    (J, aref, R, floss, active, oneside, pos) blocks.  `masked`: the
    limit rows' J and aref are multiplied by their activity
    (`_make_rows_fast`); otherwise they are left whole for the caller to
    zero (`_make_rows_ref`)."""
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
        if masked:
            actf = act.to(dtype)
            Js.append(E * sgn[..., None] * actf[..., None])
            arefs.append(aref * actf)
        else:
            Js.append(E * sgn[..., None])
            arefs.append(aref)
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
        if masked:
            actf = act.to(dtype)
            Js.append(Jt * actf[..., None])
            arefs.append(aref * actf)
        else:
            Js.append(Jt)
            arefs.append(aref)
        Rs.append(torch.clamp((1 - imp) / imp * m.ten_invweight0[lt],
                              min=MINVAL))
        fls.append(torch.zeros(B, nt, dtype=dtype, device=dev))
        actives.append(act)
        onesides.append(torch.ones(B, nt, dtype=torch.bool, device=dev))
        poss.append(dist)

    return Js, arefs, Rs, fls, actives, onesides, poss


def _rows_cat(B, xs):
    """Concatenate per-row blocks along the row axis, expanding shared
    (1-D) blocks to the batch."""
    return torch.cat([x.expand(B, *x.shape[-1:]) if x.dim() == 1 else x
                      for x in xs], dim=1)


def make_rows(m: Model, kin: Kin, qpos: torch.Tensor, qvel: torch.Tensor,
              con: CompactContacts) -> Rows:
    """The rows at (qpos, qvel) with the compacted contacts: float64
    runs `make_rows_ref`; float32 `_make_rows_fast`, with the
    base-compressed layout under MJE_JBASE=1."""
    if qpos.dtype == torch.float64:
        return make_rows_ref(m, kin, qpos, qvel, con)
    return _make_rows_fast(m, kin, qpos, qvel, con, jbase_enabled())


def _make_rows_fast(m: Model, kin: Kin, qpos: torch.Tensor,
                    qvel: torch.Tensor, con: CompactContacts,
                    jbase: bool = False) -> Rows:
    """`_make_rows_fast`: the dense facet-expanded J, or with `jbase`
    the non-contact rows in J and the contact base rows in Jbase."""
    s = m.spec
    dtype, dev = qpos.dtype, qpos.device
    B, nv = qpos.shape
    Js, arefs, Rs, fls, actives, onesides, poss = _other_rows(
        m, qpos, qvel, masked=True)

    def idx(a):
        return torch.as_tensor(a, dtype=torch.long, device=dev)

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
    livef = row_live.to(dtype)
    if jbase:
        Jbase = torch.cat([Jn_a, Jd], dim=-2).reshape(B, ncmax * 4, nv)
    else:
        Jbase = None
        plus = Jn_a + Jd
        minus = Jn_a - Jd
        facets = torch.stack([plus[..., 0, :], minus[..., 0, :],
                              plus[..., 1, :], minus[..., 1, :],
                              plus[..., 2, :], minus[..., 2, :]],
                             dim=-2)                          # (B, C, 6, nv)
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

    J = torch.cat(Js, dim=1) if Js else torch.zeros(B, 0, nv, dtype=dtype,
                                                    device=dev)
    aref = _rows_cat(B, arefs)
    R = _rows_cat(B, Rs)
    active = _rows_cat(B, actives)
    D = torch.where(active, 1.0 / R, torch.zeros_like(R))
    return Rows(J=J, aref=aref, D=D, R=R, floss=_rows_cat(B, fls),
                active=active, oneside=_rows_cat(B, onesides),
                pos=_rows_cat(B, poss), Jbase=Jbase)


def make_rows_ref(m: Model, kin: Kin, qpos: torch.Tensor, qvel: torch.Tensor,
                  con: CompactContacts) -> Rows:
    """`_make_rows_ref`, the float64 oracle-parity rows: the dense J
    built facet by facet (einsum contractions), limit rows unmasked
    until the end, where every inactive row's J and aref are zeroed."""
    s = m.spec
    dtype, dev = qpos.dtype, qpos.device
    B, nv = qpos.shape
    Js, arefs, Rs, fls, actives, onesides, poss = _other_rows(
        m, qpos, qvel, masked=False)

    # ---- contact rows (ncmax x 6 facet slots) ------------------------------
    ncmax = con.dist.shape[1]
    gb = torch.as_tensor(s.geom_bodyid, dtype=torch.long, device=dev)
    b1, b2 = gb[con.geom1], gb[con.geom2]                     # (B, C)
    jac1p, jac1r = point_jacobian(m, kin, con.pos, b1)
    jac2p, jac2r = point_jacobian(m, kin, con.pos, b2)
    djp = jac2p - jac1p                                       # (B, C, 3, nv)
    djr = jac2r - jac1r
    n, t1, t2 = con.frame[..., 0, :], con.frame[..., 1, :], con.frame[..., 2, :]
    Jn = torch.einsum("nck,nckv->ncv", n, djp)                # (B, C, nv)
    Jt1 = torch.einsum("nck,nckv->ncv", t1, djp)
    Jt2 = torch.einsum("nck,nckv->ncv", t2, djp)
    Jtor = torch.einsum("nck,nckv->ncv", n, djr)

    pid = con.pairid
    mu = m.pair_friction[pid]                                 # (B, C, 5)
    incmargin = m.pair_margin[pid] - m.pair_gap[pid]
    solref = m.pair_solref[pid]
    solimp = m.pair_solimp[pid]
    pos_m = con.dist - incmargin
    imp = _impedance(solimp, pos_m)                           # (B, C)
    k, b = _kb(solref, solimp)
    invw = m.body_invweight0[b1, 0] + m.body_invweight0[b2, 0]
    mu1 = mu[..., 0]
    diag_pyr = 2.0 * torch.clamp(mu1 * mu1 * (1.0 + mu1 * mu1), min=2.0) \
        * invw / s.impratio
    condim = con.condim

    # Facet slots 0, 1 = +-t1; 2, 3 = +-t2; 4, 5 = +-torsion; condim 1
    # uses slot 0 as the pure normal row.
    facet_dir = torch.stack([Jt1, Jt1, Jt2, Jt2, Jtor, Jtor], dim=2)
    facet_mu = torch.stack([mu[..., 0], mu[..., 0], mu[..., 1], mu[..., 1],
                            mu[..., 2], mu[..., 2]], dim=-1)  # (B, C, 6)
    facet_sgn = torch.tensor([1.0, -1.0, 1.0, -1.0, 1.0, -1.0], dtype=dtype,
                             device=dev)
    is_normal_only = (condim == 1)[..., None]                 # (B, C, 1)
    Jc = Jn[:, :, None, :] + torch.where(
        is_normal_only[..., None], torch.zeros((), dtype=dtype, device=dev),
        facet_sgn[:, None] * facet_mu[..., None] * facet_dir)  # (B,C,6,nv)
    nrows = torch.where(condim == 1, torch.ones_like(condim),
                        2 * (condim - 1))
    six = torch.arange(6, device=dev)
    row_live = (six < nrows[..., None]) & con.active[..., None]

    vel = torch.einsum("ncrv,nv->ncr", Jc, qvel)
    aref_c = -b[..., None] * vel - (k * imp * pos_m)[..., None]
    diag = torch.where(is_normal_only, invw[..., None], diag_pyr[..., None])
    R_c = torch.clamp(((1 - imp) / imp)[..., None] * diag,
                      min=MINVAL).expand(B, ncmax, 6)
    Js.append(Jc.reshape(B, ncmax * 6, nv))
    arefs.append(aref_c.reshape(B, -1))
    Rs.append(R_c.reshape(B, -1))
    fls.append(torch.zeros(B, ncmax * 6, dtype=dtype, device=dev))
    actives.append(row_live.reshape(B, -1))
    onesides.append(torch.ones(B, ncmax * 6, dtype=torch.bool, device=dev))
    poss.append(con.dist[..., None].expand(B, ncmax, 6).reshape(B, -1))

    R = _rows_cat(B, Rs)
    active = _rows_cat(B, actives)
    zero = torch.zeros((), dtype=dtype, device=dev)
    D = torch.where(active, 1.0 / R, zero)
    # Inactive rows are fully neutralized.
    J = torch.where(active[..., None], torch.cat(Js, dim=1), zero)
    aref = torch.where(active, _rows_cat(B, arefs), zero)
    return Rows(J=J, aref=aref, D=D, R=R, floss=_rows_cat(B, fls),
                active=active, oneside=_rows_cat(B, onesides),
                pos=_rows_cat(B, poss))
