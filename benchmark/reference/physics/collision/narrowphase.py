"""Analytic narrowphase for the suite's fourteen primitive pair types
(`mj_envs_tpu/physics/collision/narrowphase.py`), batch-first.

Every pair function takes one batch of N (env, pair) instances —
positions (N, 3), frames (N, 3, 3), sizes (N, 3), margins (N,) — and
returns (dist (N, C), pos (N, C, 3), nrm (N, C, 3)) for its C contact
candidates.  Conventions match mujoco: pairs are type-sorted, the normal
points from geom1 toward geom2, `dist` is the signed separation, `pos`
the midpoint, and unused candidates report dist = +BIG.

The JAX functions' one-hot selects and iota tricks are TPU lowering
workarounds; here they are gathers and plain indexing with the same
outputs.  Helpers broadcast over any leading axes (scalars carry a
trailing singleton where they meet vectors).
"""
from __future__ import annotations

import numpy as np
import torch

from ..maths import cross, norm

BIG = 1e10

# Iteration budgets of the iterative convex paths (as in the JAX package).
AP_ITERS = 48
POLISH_ITERS = 24
GS_ITERS = 24


def _mv(a, v):
    """Tiny matrix @ vector over leading axes."""
    return (a * v[..., None, :]).sum(-1)


def _mm(a, b):
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _T(m):
    return m.transpose(-1, -2)


def _vdot(a, b):
    return (a * b).sum(-1)


def _e(k, like):
    e = torch.zeros(3, dtype=like.dtype, device=like.device)
    e[k] = 1.0
    return e


def _onehot(i, like):
    """(..., 3) one-hot rows of integer index tensor i."""
    return torch.nn.functional.one_hot(i, 3).to(like.dtype)


def _pick(v, i):
    """v[..., i] for an index tensor i over the leading axes."""
    return torch.gather(v, -1, i[..., None])[..., 0]


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _midpos(p_on_1, p_on_2):
    return 0.5 * (p_on_1 + p_on_2)


def _s3(dtype) -> float:
    """sqrt(3)/2 rounded as the JAX code rounds it in this dtype."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    return float(np.sqrt(np_dt(3.0)) / np_dt(2.0))


def _safe_normalize(v, fallback, eps=1e-12):
    n = norm(v)
    return torch.where((n > eps)[..., None], v / torch.clamp(n, min=eps)[..., None],
                  fallback), n


def _safe_unit(v, fallback):
    ln = norm(v)
    return torch.where((ln > 1e-10)[..., None],
                  v / torch.clamp(ln, min=1e-10)[..., None], fallback)


def _ortho(v):
    """Any unit vector orthogonal to unit v."""
    other = torch.where((v[..., 0].abs() < 0.5)[..., None], _e(0, v), _e(1, v))
    w = cross(v, other)
    return w / norm(w)[..., None]


def _one(dist, pos, n):
    """One contact candidate: add the candidate axis."""
    return dist[..., None], pos[..., None, :], n[..., None, :]


# ---------------------------------------------------------------------------
# plane-X (plane normal = column 2 of its frame; surface through pos1)
# ---------------------------------------------------------------------------

def plane_sphere(p1, m1, s1, p2, m2, s2, margin):
    n = m1[..., :, 2]
    r = s2[..., 0]
    dist = _vdot(n, p2 - p1) - r
    return _one(dist, p2 - n * (r + 0.5 * dist)[..., None], n)


def plane_capsule(p1, m1, s1, p2, m2, s2, margin):
    n = m1[..., :, 2]
    axis = m2[..., :, 2]
    r, hl = s2[..., 0], s2[..., 1]
    ends = torch.stack([p2 + axis * hl[..., None],
                        p2 - axis * hl[..., None]], dim=-2)      # (N, 2, 3)
    h = _mv(ends, n) - _vdot(p1, n)[..., None]
    dist = h - r[..., None]
    pos = ends - n[..., None, :] * (r[..., None] + 0.5 * dist)[..., None]
    return dist, pos, torch.stack([n, n], dim=-2)


def plane_cylinder(p1, m1, s1, p2, m2, s2, margin=None):
    """Up to 4 candidates (mujoco 3.x mjc_PlaneCylinder): deepest rim
    point of the near cap, two near-cap rim points at +-120 deg, and the
    far-cap rim point at the deepest azimuth."""
    n = m1[..., :, 2]
    axis = m2[..., :, 2]
    r, hl = s2[..., 0:1], s2[..., 1:2]
    ca = _vdot(n, axis)[..., None]
    prj = axis * ca - n
    prjn = norm(prj)[..., None]
    standing = prjn < 1e-10
    rad = torch.where(standing, m2[..., :, 0],
                      prj / torch.clamp(prjn, min=1e-12))
    cap = p2 + axis * (hl * torch.where(ca < 0, 1.0, -1.0))
    far_cap = 2.0 * p2 - cap
    t2v = cross(axis, rad)
    c120, s120 = -0.5, _s3(p1.dtype)
    pts = torch.stack([
        cap + r * rad,
        cap + r * (c120 * rad + s120 * t2v),
        cap + r * (c120 * rad - s120 * t2v),
        far_cap + r * rad,
    ], dim=-2)                                                  # (N, 4, 3)
    dist = _mv(pts, n) - _vdot(p1, n)[..., None]
    pos = pts - n[..., None, :] * (0.5 * dist)[..., None]
    return dist, pos, n[..., None, :].expand(pts.shape)


_BOX_SIGNS = np.array([[2 * ((i // (4 // 2 ** c)) % 2) - 1 for c in range(3)]
                       for i in range(8)], dtype=np.float64)   # (8, 3)


def plane_box(p1, m1, s1, p2, m2, s2, margin):
    """All 8 corners; the driver keeps the active ones."""
    n = m1[..., :, 2]
    signs = torch.as_tensor(_BOX_SIGNS, dtype=p1.dtype, device=p1.device)
    corners = p2[..., None, :] + _mm(signs * s2[..., None, :], _T(m2))
    dist = _mv(corners, n) - _vdot(p1, n)[..., None]
    pos = corners - n[..., None, :] * (0.5 * dist)[..., None]
    return dist, pos, n[..., None, :].expand(corners.shape)


# ---------------------------------------------------------------------------
# segment / box / cylinder helpers
# ---------------------------------------------------------------------------

def _closest_on_segment(a, b, p):
    ab = b - a
    t = _clip(_vdot(p - a, ab) / torch.clamp(_vdot(ab, ab), min=1e-15),
              torch.full_like(ab[..., 0], 0.0), torch.full_like(ab[..., 0], 1.0))
    return a + t[..., None] * ab


def _segment_closest(a1, b1, a2, b2):
    """Closest points between segments [a1,b1], [a2,b2], plus whether
    they are (near-)parallel."""
    d1 = b1 - a1
    d2 = b2 - a2
    r = a1 - a2
    A = _vdot(d1, d1)
    e = _vdot(d2, d2)
    f = _vdot(d2, r)
    c = _vdot(d1, r)
    b = _vdot(d1, d2)
    denom = A * e - b * b
    zero, one = torch.zeros_like(A), torch.ones_like(A)
    s = torch.where(denom > 1e-14,
               _clip((b * f - c * e) / torch.clamp(denom, min=1e-14),
                     zero, one), zero)
    t = (b * s + f) / torch.clamp(e, min=1e-14)
    t_cl = _clip(t, zero, one)
    s2c = _clip((b * t_cl - c) / torch.clamp(A, min=1e-14), zero, one)
    p1 = a1 + d1 * s2c[..., None]
    p2c = a2 + d2 * t_cl[..., None]
    parallel = denom <= 1e-10 * A * e
    return p1, p2c, parallel


def _closest_on_box(p, c, m, size):
    """Closest point on a solid box's surface to p, and whether p is
    inside (then pushed out through the nearest face)."""
    lp = _mv(_T(m), p - c)
    clamped = _clip(lp, -size, size)
    inside = (lp.abs() <= size).all(-1)
    gap = size - lp.abs()
    k = torch.argmin(gap, dim=-1)
    ohk = _onehot(k, lp)
    lpk = _pick(lp, k)
    szk = _pick(size.expand(lp.shape), k)
    proj = clamped * (1.0 - ohk) + ohk * (torch.sign(lpk + 1e-30)
                                          * szk)[..., None]
    lsurf = torch.where(inside[..., None], proj, clamped)
    return c + _mv(m, lsurf), inside


def _closest_on_cylinder_surface(p, c, axis, r, hl):
    """Closest point on a solid cylinder's surface to p; interior points
    are pushed out through the nearer of side and cap."""
    rel = p - c
    z = _vdot(rel, axis)
    radial = rel - z[..., None] * axis
    rn = norm(radial)
    rdir = torch.where((rn > 1e-12)[..., None],
                  radial / torch.clamp(rn, min=1e-12)[..., None],
                  _ortho(axis).expand(radial.shape))
    inside = (z.abs() <= hl) & (rn <= r)
    zc = _clip(z, -hl, hl)
    surf_out = c + axis * zc[..., None] + rdir * torch.minimum(rn, r)[..., None]
    d_side = r - rn
    d_cap = hl - z.abs()
    use_side = d_side <= d_cap
    surf_in = torch.where(
        use_side[..., None],
        c + axis * z[..., None] + rdir * r[..., None],
        c + axis * (torch.sign(z + 1e-30) * hl)[..., None]
        + rdir * rn[..., None])
    return torch.where(inside[..., None], surf_in, surf_out), inside


def _sphere_point_box(pt_w, r, p2, m2, s2):
    """Sphere of radius r at pt_w vs box: (dist, pos, n)."""
    surf, inside = _closest_on_box(pt_w, p2, m2, s2)
    d = surf - pt_w
    ln = norm(d)
    n = torch.where((ln > 1e-12)[..., None],
               d / torch.clamp(ln, min=1e-12)[..., None],
               _e(2, d).expand(d.shape))
    n = torch.where(inside[..., None], -n, n)
    dist = torch.where(inside, -ln, ln) - r
    pos = _midpos(pt_w + n * r[..., None], surf)
    return dist, pos, n


# ---------------------------------------------------------------------------
# sphere-X (one contact; the normal points from the sphere, geom1)
# ---------------------------------------------------------------------------

def sphere_sphere(p1, m1, s1, p2, m2, s2, margin):
    r1, r2 = s1[..., 0:1], s2[..., 0:1]
    d = p2 - p1
    n, ln = _safe_normalize(d, _e(2, d).expand(d.shape))
    return _one(ln - s1[..., 0] - s2[..., 0],
                _midpos(p1 + n * r1, p2 - n * r2), n)


def sphere_capsule(p1, m1, s1, p2, m2, s2, margin):
    r1, r2 = s1[..., 0:1], s2[..., 0:1]
    axis = m2[..., :, 2]
    hl = s2[..., 1:2]
    c = _closest_on_segment(p2 - axis * hl, p2 + axis * hl, p1)
    d = c - p1
    n, ln = _safe_normalize(d, _e(2, d).expand(d.shape))
    return _one(ln - s1[..., 0] - s2[..., 0],
                _midpos(p1 + n * r1, c - n * r2), n)


def sphere_cylinder(p1, m1, s1, p2, m2, s2, margin):
    axis = m2[..., :, 2]
    surf, inside = _closest_on_cylinder_surface(p1, p2, axis, s2[..., 0],
                                                s2[..., 1])
    d = surf - p1
    ln = norm(d)
    n = torch.where((ln > 1e-12)[..., None],
                    d / torch.clamp(ln, min=1e-12)[..., None], _ortho(axis))
    n = torch.where(inside[..., None], -n, n)
    return _one(torch.where(inside, -ln, ln) - s1[..., 0],
                _midpos(p1 + n * s1[..., 0:1], surf), n)


def sphere_box(p1, m1, s1, p2, m2, s2, margin):
    return _one(*_sphere_point_box(p1, s1[..., 0], p2, m2, s2))


# ---------------------------------------------------------------------------
# capsule-X
# ---------------------------------------------------------------------------

def capsule_capsule(p1, m1, s1, p2, m2, s2, margin):
    """The closest-point contact, plus a second contact at the other end
    of the overlap interval when the capsules are (near-)parallel."""
    r1, h1 = s1[..., 0], s1[..., 1]
    r2, h2 = s2[..., 0], s2[..., 1]
    ax1, ax2 = m1[..., :, 2], m2[..., :, 2]
    a1, b1 = p1 - ax1 * h1[..., None], p1 + ax1 * h1[..., None]
    a2, b2 = p2 - ax2 * h2[..., None], p2 + ax2 * h2[..., None]

    c1, c2, parallel = _segment_closest(a1, b1, a2, b2)
    n, ln = _safe_normalize(c2 - c1, _ortho(ax1))
    dist_a = ln - r1 - r2
    pos_a = _midpos(c1 + n * r1[..., None], c2 - n * r2[..., None])

    t_a2 = _vdot(a2 - a1, ax1)
    t_b2 = _vdot(b2 - a1, ax1)
    lo = torch.clamp(torch.minimum(t_a2, t_b2), min=0.0)
    hi = torch.minimum(2.0 * h1, torch.maximum(t_a2, t_b2))
    t_first = _vdot(c1 - a1, ax1)
    t_other = torch.where((t_first - lo).abs() > (t_first - hi).abs(), lo, hi)
    c1b = a1 + ax1 * t_other[..., None]
    c2b = _closest_on_segment(a2, b2, c1b)
    nb, lnb = _safe_normalize(c2b - c1b, n)
    dist_b = lnb - r1 - r2
    pos_b = _midpos(c1b + nb * r1[..., None], c2b - nb * r2[..., None])
    valid_b = parallel & (hi > lo) & ((t_other - t_first).abs() > 1e-9)
    dist_b = torch.where(valid_b, dist_b, torch.full_like(dist_b, BIG))
    return (torch.stack([dist_a, dist_b], -1),
            torch.stack([pos_a, pos_b], -2), torch.stack([n, nb], -2))


def capsule_box(p1, m1, s1, p2, m2, s2, margin):
    """Capsule (geom1) vs box (geom2), up to 2 contacts: the axis segment
    clipped against the supporting face's rectangle, a sphere-box contact
    at each clip end; the single closest-point contact on a miss."""
    r, hl = s1[..., 0], s1[..., 1]
    ax = m1[..., :, 2]
    a = p1 - ax * hl[..., None]
    b = p1 + ax * hl[..., None]
    m2T = _T(m2)
    al = _mv(m2T, a - p2)
    bl = _mv(m2T, b - p2)
    dl = bl - al
    kf = torch.argmax(_mv(m2T, p1 - p2).abs() / s2, dim=-1)

    t_lo = torch.zeros_like(r)
    t_hi = torch.ones_like(r)
    miss = torch.zeros_like(r, dtype=torch.bool)
    for k in range(3):
        dk = dl[..., k]
        is_face = kf == k
        parallel_k = dk.abs() < 1e-13
        safe = torch.where(parallel_k, torch.ones_like(dk), dk)
        t1 = (-s2[..., k] - al[..., k]) / safe
        t2 = (s2[..., k] - al[..., k]) / safe
        skip = is_face | parallel_k
        t_lo = torch.where(skip, t_lo, torch.maximum(t_lo, torch.minimum(t1, t2)))
        t_hi = torch.where(skip, t_hi, torch.minimum(t_hi, torch.maximum(t1, t2)))
        miss = miss | (parallel_k & ~is_face
                       & (al[..., k].abs() > s2[..., k] + r))
    miss = miss | (t_lo > t_hi)
    t_a = torch.minimum(torch.clamp(t_lo, min=0.0), t_hi)
    t_b = torch.minimum(torch.clamp(t_lo, min=1.0), t_hi)

    # Exact closest point of the segment to the box (fixed point of the
    # clamp projection) for the miss/fallback contact.
    t_fp = torch.full_like(r, 0.5)
    dd = torch.clamp(_vdot(dl, dl), min=1e-15)
    for _ in range(12):
        cl = _clip(al + t_fp[..., None] * dl, -s2, s2)
        t_fp = torch.clamp(_vdot(cl - al, dl) / dd, 0.0, 1.0)
    t_a = torch.where(miss, t_fp, t_a)

    pa_w = p2 + _mv(m2, al + t_a[..., None] * dl)
    pb_w = p2 + _mv(m2, al + t_b[..., None] * dl)
    dist_a, pos_a, n_a = _sphere_point_box(pa_w, r, p2, m2, s2)
    dist_b, pos_b, n_b = _sphere_point_box(pb_w, r, p2, m2, s2)
    big = torch.full_like(dist_b, BIG)
    dist_b = torch.where(miss, big, dist_b)

    pf2_w = p2 + _mv(m2, al + t_fp[..., None] * dl)
    dist_f, pos_f, n_f = _sphere_point_box(pf2_w, r, p2, m2, s2)
    use_fb = miss | ((dist_a >= margin) & (dist_b >= margin))
    dist_a = torch.where(use_fb, dist_f, dist_a)
    pos_a = torch.where(use_fb[..., None], pos_f, pos_a)
    n_a = torch.where(use_fb[..., None], n_f, n_a)
    dist_b = torch.where(use_fb, big, dist_b)
    return (torch.stack([dist_a, dist_b], -1),
            torch.stack([pos_a, pos_b], -2), torch.stack([n_a, n_b], -2))


def capsule_cylinder(p1, m1, s1, p2, m2, s2, margin):
    """Capsule (geom1) vs cylinder (geom2), up to 2 contacts: the capsule
    segment's closest point to the solid cylinder by 17 samples plus a
    golden-section refine; a second contact when the axes are parallel."""
    r1, h1 = s1[..., 0], s1[..., 1]
    ax1 = m1[..., :, 2]
    a = p1 - ax1 * h1[..., None]
    b = p1 + ax1 * h1[..., None]
    ax2 = m2[..., :, 2]
    r2, h2 = s2[..., 0], s2[..., 1]

    def point_dist(t):
        """Signed distance of segment point(s) a + t (b - a); t (N,) or
        (N, K)."""
        extra = t.dim() - r1.dim()
        ex = (lambda x: x.reshape(x.shape[:r1.dim()] + (1,) * extra
                                  + x.shape[r1.dim():]))
        pt = ex(a) + t[..., None] * ex(b - a)
        surf, inside = _closest_on_cylinder_surface(
            pt, ex(p2), ex(ax2), ex(r2), ex(h2))
        ln = norm(surf - pt)
        return torch.where(inside, -ln, ln), pt, surf

    ts = torch.arange(17, dtype=p1.dtype, device=p1.device) / 16.0
    dists, _, _ = point_dist(ts.expand(r1.shape + (17,)))
    t_i = ts[torch.argmin(dists, dim=-1)]
    lo = torch.clamp(t_i - 1.0 / 16.0, 0.0, 1.0)
    hi = torch.clamp(t_i + 1.0 / 16.0, 0.0, 1.0)
    gr = 0.618033988749895
    for _ in range(GS_ITERS):
        m_lo = hi - gr * (hi - lo)
        m_hi = lo + gr * (hi - lo)
        f_lo = point_dist(m_lo)[0]
        f_hi = point_dist(m_hi)[0]
        keep_lo = f_lo < f_hi
        lo, hi = torch.where(keep_lo, lo, m_lo), torch.where(keep_lo, m_hi, hi)
    t_best = 0.5 * (lo + hi)
    dmin, pt, surf = point_dist(t_best)
    dvec = surf - pt
    ln = norm(dvec)
    n_out = torch.where((ln > 1e-12)[..., None],
                   dvec / torch.clamp(ln, min=1e-12)[..., None], _ortho(ax2))
    n = torch.where((dmin < 0)[..., None], -n_out, n_out)
    dist_a = dmin - r1
    pos_a = _midpos(pt + n * r1[..., None], surf)

    parallel = _vdot(ax1, ax2).abs() > 0.999
    t_other = torch.where(t_best < 0.5, torch.ones_like(t_best),
                     torch.zeros_like(t_best))
    d2, pt2, surf2 = point_dist(t_other)
    d2vec = surf2 - pt2
    ln2 = norm(d2vec)
    n2 = torch.where((ln2 > 1e-12)[..., None],
                d2vec / torch.clamp(ln2, min=1e-12)[..., None], n)
    n2 = torch.where((d2 < 0)[..., None], -n2, n2)
    dist_b = torch.where(parallel, d2 - r1, torch.full_like(d2, BIG))
    pos_b = _midpos(pt2 + n2 * r1[..., None], surf2)
    return (torch.stack([dist_a, dist_b], -1),
            torch.stack([pos_a, pos_b], -2), torch.stack([n, n2], -2))


# ---------------------------------------------------------------------------
# convex solids: projections, supports, and the generic contact
# ---------------------------------------------------------------------------

def _proj_cyl_solid(x, c, axis, r, hl):
    """Euclidean projection of x onto the solid cylinder (c, axis, r, hl)."""
    rel = x - c
    z = _vdot(rel, axis)
    rad = rel - z[..., None] * axis
    rn = norm(rad)
    rdir = torch.where((rn > 1e-12)[..., None],
                  rad / torch.clamp(rn, min=1e-12)[..., None], _ortho(axis))
    return c + axis * _clip(z, -hl, hl)[..., None] \
        + rdir * torch.minimum(rn, r)[..., None]


def _proj_box_solid(x, c, m, size):
    return c + _mv(m, _clip(_mv(_T(m), x - c), -size, size))


def _supp_cyl(d, c, axis, r, hl):
    """Support value of a solid cylinder along unit direction(s) d."""
    za = _vdot(d, axis)
    perp = norm(d - za[..., None] * axis)
    return _vdot(d, c) + hl * za.abs() + r * perp


def _supp_cyl_grad(d, c, axis, r, hl):
    """d/dd of `_supp_cyl` (the support point), by the chain rule JAX's
    autodiff applies: d|x|/dx = +1 at x >= 0, -1 below; d sqrt(s) =
    0.5 / sqrt(s) ds."""
    za = _vdot(d, axis)
    perpv = d - za[..., None] * axis
    h = r * (0.5 / norm(perpv))
    u = h[..., None] * perpv + h[..., None] * perpv
    sg = torch.where(za >= 0, torch.ones_like(za), -torch.ones_like(za))
    ct_za = hl * sg - _vdot(u, axis)
    return c + u + ct_za[..., None] * axis


def _supp_box(d, c, m, size):
    return _vdot(d, c) + _vdot(_mv(_T(m), d).abs(), size)


def _supp_box_grad(d, c, m, size):
    dl = _mv(_T(m), d)
    sg = torch.where(dl >= 0, torch.ones_like(dl), -torch.ones_like(dl))
    return c + _mv(m, sg * size)


def _supp_point_cyl(d, c, axis, r, hl, ref):
    """Support POINT of a solid cylinder along d; degenerate coordinates
    (side line, cap disc) are resolved toward `ref`."""
    za = _vdot(d, axis)
    perp = d - za[..., None] * axis
    pn = norm(perp)
    relr = ref - c
    zr = _vdot(relr, axis)
    rad_r = relr - zr[..., None] * axis
    pdir = torch.where((pn > 1e-6)[..., None],
                  perp / torch.clamp(pn, min=1e-12)[..., None],
                  _safe_unit(rad_r, _ortho(axis)))
    zc = torch.where(za.abs() > 1e-6, hl * torch.sign(za), _clip(zr, -hl, hl))
    rc = torch.where(za.abs() > 0.999999, torch.minimum(norm(rad_r), r), r)
    return c + axis * zc[..., None] + pdir * rc[..., None]


def _supp_point_box(d, c, m, size, ref):
    dl = _mv(_T(m), d)
    rl = _mv(_T(m), ref - c)
    coord = torch.where(dl.abs() > 1e-6, torch.sign(dl) * size,
                   _clip(rl, -size, size))
    return c + _mv(m, coord)


def _convex_contact(projA, projB, x0, fallback_n, suppA, gradA, suppB,
                    gradB, cand_dirs, suppPA, suppPB):
    """Contact between two convex solids (n from A toward B).

    Alternating projection on the pre-shrunk solids estimates the
    normal; the signed distance is the support gap of the original
    solids along it, polished by projected gradient ascent from the best
    of {AP direction} and the candidate directions (K, multi-start).
    When a candidate decisively wins, the position is the midpoint of
    the support witnesses instead of the AP midpoint."""
    x = y = x0
    for _ in range(AP_ITERS):
        x = projA(y)
        y = projB(x)
    d = y - x
    ln = norm(d)
    n = torch.where((ln > 1e-10)[..., None],
               d / torch.clamp(ln, min=1e-10)[..., None], fallback_n)

    def gap(v):
        return -suppB(-v) - suppA(v)

    gap_ap = gap(n)
    gaps_c = gap(cand_dirs)                                   # (N, K)
    g_best, i_best = torch.max(gaps_c, dim=-1)
    n_cand = torch.gather(
        cand_dirs, -2, i_best[..., None, None].expand(n.shape[:-1] + (1, 3))
    )[..., 0, :]
    n = torch.where((g_best > gap_ap)[..., None], n_cand, n)
    gap_best = torch.maximum(g_best, gap_ap)
    n_best = n
    step = torch.full_like(gap_best, 0.25)
    for _ in range(POLISH_ITERS):
        grad = gradB(-n) - gradA(n)
        tang = grad - _vdot(grad, n)[..., None] * n
        n_try = n + step[..., None] * tang
        n_try = n_try / torch.clamp(norm(n_try), min=1e-12)[..., None]
        g_try = gap(n_try)
        improved = g_try > gap_best
        n_best = torch.where(improved[..., None], n_try, n_best)
        gap_best = torch.where(improved, g_try, gap_best)
        n = torch.where(improved[..., None], n_try, n)
        step = torch.where(improved, step, step * 0.5)
    n, dist = n_best, gap_best
    pos = 0.5 * (x + y)
    aw = suppPA(n, pos)
    bw = suppPB(-n, aw)
    aw = suppPA(n, bw)
    use_w = dist > gap_ap + 1e-7
    pos = torch.where(use_w[..., None], 0.5 * (aw + bw), pos)
    return dist, pos, n


def _cyl_fns(c, axis, r, hl):
    """(support, support gradient, support point) of a cylinder, with
    its parameters broadcast against direction batches (..., K, 3)."""
    def bc(x, v, vec):
        return x[..., None, :] if (vec and v.dim() > x.dim()) else \
            (x[..., None] if (not vec and v.dim() - 1 > x.dim()) else x)

    def supp(v):
        return _supp_cyl(v, bc(c, v, True), bc(axis, v, True),
                         bc(r, v, False), bc(hl, v, False))

    def grad(v):
        return _supp_cyl_grad(v, c, axis, r, hl)

    def point(v, ref):
        return _supp_point_cyl(v, c, axis, r, hl, ref)
    return supp, grad, point


def _box_fns(c, m, size):
    def supp(v):
        if v.dim() > c.dim():
            return _supp_box(v, c[..., None, :], m[..., None, :, :],
                             size[..., None, :])
        return _supp_box(v, c, m, size)

    def grad(v):
        return _supp_box_grad(v, c, m, size)

    def point(v, ref):
        return _supp_point_box(v, c, m, size, ref)
    return supp, grad, point


# ---------------------------------------------------------------------------
# cylinder pairs
# ---------------------------------------------------------------------------

def cylinder_cylinder(p1, m1, s1, p2, m2, s2, margin):
    """4 candidates: cap-cap ring (3 points at 120 deg + center) for
    stacked parallel axes, a 2-point line for side-by-side parallel axes,
    else one generic convex contact."""
    r1, h1 = s1[..., 0], s1[..., 1]
    r2, h2 = s2[..., 0], s2[..., 1]
    ax1, ax2 = m1[..., :, 2], m2[..., :, 2]

    parallel = _vdot(ax1, ax2).abs() > 0.999
    rel = p2 - p1
    z = _vdot(rel, ax1)
    radial = rel - z[..., None] * ax1
    rn = norm(radial)
    rdir = torch.where((rn > 1e-12)[..., None],
                  radial / torch.clamp(rn, min=1e-12)[..., None], _ortho(ax1))

    # cap-cap
    axial_gap = z.abs() - (h1 + h2)
    radial_gap = rn - (r1 + r2)
    cap_case = parallel & (rn < torch.maximum(r1, r2))
    n_cc = ax1 * torch.sign(z + 1e-30)[..., None]
    ring_r = torch.minimum(r1, r2)[..., None]
    t1v = _ortho(ax1)
    t2v = cross(ax1, t1v)
    ring_c = torch.where((r1 < r2)[..., None],
                    p1 + n_cc * (h1 + 0.5 * axial_gap)[..., None],
                    p2 - n_cc * (h2 + 0.5 * axial_gap)[..., None])
    c120, s120 = -0.5, _s3(p1.dtype)
    pos_cc = torch.stack([
        ring_c + ring_r * t1v,
        ring_c + ring_r * (c120 * t1v + s120 * t2v),
        ring_c + ring_r * (c120 * t1v - s120 * t2v),
        ring_c], dim=-2)
    dist_cc = axial_gap[..., None].expand(pos_cc.shape[:-1])

    # side-side parallel
    z2lo, z2hi = z - h2, z + h2
    lo = torch.maximum(-h1, torch.minimum(z2lo, z2hi))
    hi = torch.minimum(h1, torch.maximum(z2lo, z2hi))
    mid = 0.5 * (lo + hi)
    pts_ax = torch.stack([lo, hi, mid, mid], -1)               # (N, 4)
    surf1 = p1[..., None, :] + pts_ax[..., None] * ax1[..., None, :] \
        + (rdir * r1[..., None])[..., None, :]
    surf2 = surf1 + (rdir * radial_gap[..., None])[..., None, :]
    pos_ss = 0.5 * (surf1 + surf2)
    big = torch.full_like(radial_gap, BIG)
    dist_ss = torch.stack([radial_gap, radial_gap, big, big], -1)
    ss_valid = hi > lo

    # generic: convex contact between the solids
    a1, b1 = p1 - ax1 * h1[..., None], p1 + ax1 * h1[..., None]
    a2, b2 = p2 - ax2 * h2[..., None], p2 + ax2 * h2[..., None]
    c1, c2, _ = _segment_closest(a1, b1, a2, b2)
    shrink = 0.3 * torch.minimum(torch.minimum(r1, h1), torch.minimum(r2, h2))
    cr = _safe_unit(cross(ax1, ax2), rdir)
    cands = torch.stack([rdir, -rdir, ax1, -ax1, ax2, -ax2, cr, -cr], -2)
    sA, gA, pA = _cyl_fns(p1, ax1, r1, h1)
    sB, gB, pB = _cyl_fns(p2, ax2, r2, h2)
    dist_g, pos_g, n_g = _convex_contact(
        lambda x: _proj_cyl_solid(x, p1, ax1, r1 - shrink, h1 - shrink),
        lambda x: _proj_cyl_solid(x, p2, ax2, r2 - shrink, h2 - shrink),
        0.5 * (c1 + c2), rdir, sA, gA, sB, gB, cands, pA, pB)
    dist_g4 = torch.stack([dist_g, big, big, big], -1)

    side_case = parallel & ~cap_case & ss_valid
    cc, sc = cap_case[..., None], side_case[..., None]
    dist = torch.where(cc, dist_cc, torch.where(sc, dist_ss, dist_g4))
    pos = torch.where(cc[..., None], pos_cc,
                 torch.where(sc[..., None], pos_ss,
                        pos_g[..., None, :].expand(pos_cc.shape)))
    nrm = torch.where(cc, n_cc, torch.where(sc, rdir, n_g))
    return dist, pos, nrm[..., None, :].expand(pos.shape)


def _frame_from_z(z):
    x = _ortho(z)
    return torch.stack([x, cross(z, x), z], dim=-1)


def cylinder_box(p1, m1, s1, p2, m2, s2, margin):
    """Cylinder (geom1) vs box (geom2), 4 candidates: cap-on-face (rim
    points as plane_cylinder against the face), side-on-face (2-point
    line), else one generic convex contact."""
    r, hl = s1[..., 0], s1[..., 1]
    ax = m1[..., :, 2]
    m2T = _T(m2)

    rel_l = _mv(m2T, p1 - p2)
    k = torch.argmax(rel_l.abs() / s2, dim=-1)
    ohk = _onehot(k, rel_l)
    sgn = torch.sign(_pick(rel_l, k) + 1e-30)
    face_n = _mv(m2, ohk * sgn[..., None])                     # outward
    face_c = p2 + face_n * _pick(s2, k)[..., None]

    ca = _vdot(face_n, ax)
    in_face = ohk == 0
    stand_valid = (~in_face | (rel_l.abs() <= s2 + r[..., None])).all(-1)
    standing = (ca.abs() > 0.999) & stand_valid
    dists_pc, pos_pc, _ = plane_cylinder(face_c, _frame_from_z(face_n), s2,
                                         p1, m1, s1)
    pos_l = _mv(m2T[..., None, :, :], pos_pc - p2[..., None, :])  # (N,4,3)
    pos_l_cl = torch.where(~in_face[..., None, :], pos_l,
                      _clip(pos_l, -s2[..., None, :], s2[..., None, :]))
    pos_cf = p2[..., None, :] + _mv(m2[..., None, :, :], pos_l_cl)

    # side-on-face: the axis segment clipped against the face rectangle.
    a = p1 - ax * hl[..., None]
    b = p1 + ax * hl[..., None]
    al = _mv(m2T, a - p2)
    dl2 = _mv(m2T, b - p2) - al
    t_lo = torch.zeros_like(r)
    t_hi = torch.ones_like(r)
    ly_ok = torch.ones_like(r, dtype=torch.bool)
    for dim in range(3):
        is_face = k == dim
        par = dl2[..., dim].abs() < 1e-12
        safe = torch.where(par, torch.ones_like(r), dl2[..., dim])
        t1 = (-s2[..., dim] - al[..., dim]) / safe
        t2 = (s2[..., dim] - al[..., dim]) / safe
        skip = is_face | par
        t_lo = torch.where(skip, t_lo, torch.maximum(t_lo, torch.minimum(t1, t2)))
        t_hi = torch.where(skip, t_hi, torch.minimum(t_hi, torch.maximum(t1, t2)))
        ly_ok = ly_ok & (~(par & ~is_face)
                         | (al[..., dim].abs() <= s2[..., dim]))
    ly_ok = ly_ok & (t_lo <= t_hi)
    lying = (ca.abs() < 1e-3) & ly_ok
    pa = a + t_lo[..., None] * (b - a)
    pb = b + (t_hi - 1.0)[..., None] * (b - a)
    da = _vdot(pa - face_c, face_n) - r
    db = _vdot(pb - face_c, face_n) - r
    d_shared = torch.minimum(da, db)
    pa = pa - face_n * (r + 0.5 * d_shared)[..., None]
    pb = pb - face_n * (r + 0.5 * d_shared)[..., None]
    big = torch.full_like(d_shared, BIG)
    dist_ly = torch.stack([d_shared, d_shared, big, big], -1)
    pos_ly = torch.stack([pa, pb, pa, pb], -2)

    # generic
    shrink = 0.3 * torch.minimum(torch.minimum(r, hl), s2.min(-1).values)
    rel_cb = _safe_unit(p2 - p1, -face_n)
    cands = torch.stack([rel_cb, -rel_cb, ax, -ax,
                         m2[..., :, 0], -m2[..., :, 0], m2[..., :, 1],
                         -m2[..., :, 1], m2[..., :, 2], -m2[..., :, 2]], -2)
    sA, gA, pA = _cyl_fns(p1, ax, r, hl)
    sB, gB, pB = _box_fns(p2, m2, s2)
    dist_g, pos_g, n_g = _convex_contact(
        lambda x: _proj_cyl_solid(x, p1, ax, r - shrink, hl - shrink),
        lambda x: _proj_box_solid(x, p2, m2, s2 - shrink[..., None]),
        0.5 * (p1 + p2), -face_n, sA, gA, sB, gB, cands, pA, pB)
    dist_g4 = torch.stack([dist_g, big, big, big], -1)

    st, ly = standing[..., None], lying[..., None]
    dist = torch.where(st, dists_pc, torch.where(ly, dist_ly, dist_g4))
    pos = torch.where(st[..., None], pos_cf,
                 torch.where(ly[..., None], pos_ly,
                        pos_g[..., None, :].expand(pos_ly.shape)))
    nrm = torch.where(st | ly, -face_n, n_g)
    return dist, pos, nrm[..., None, :].expand(pos.shape)


# ---------------------------------------------------------------------------
# box-box (separating axes + reference-face clipping)
# ---------------------------------------------------------------------------

def _box_face_manifold(p_ref, R_ref, s_ref, p_inc, R_inc, s_inc, n_world):
    """Incident box face against the reference face rectangle; n_world
    points from the reference box toward the incident box.  Returns
    (dist (N, 24), pos (N, 24, 3)): all intersection-polygon candidates
    (incident corners in the rect, edge crossings, rect corners in the
    quad), invalid ones at +BIG."""
    dtype, dev = p_ref.dtype, p_ref.device
    nl_ref = _mv(_T(R_ref), n_world)
    kref = torch.argmax(nl_ref.abs(), dim=-1)
    sref = torch.sign(_pick(nl_ref, kref) + 1e-30)
    nl_inc = _mv(_T(R_inc), n_world)
    kinc = torch.argmax(nl_inc.abs(), dim=-1)
    sinc = -torch.sign(_pick(nl_inc, kinc) + 1e-30)

    e_k = _onehot(kinc, p_ref)
    e_u = _onehot((kinc + 1) % 3, p_ref)
    e_v = _onehot((kinc + 2) % 3, p_ref)
    sz_k = _pick(s_inc, kinc)[..., None]
    sz_u = _pick(s_inc, (kinc + 1) % 3)[..., None]
    sz_v = _pick(s_inc, (kinc + 2) % 3)[..., None]
    base = e_k * sz_k * sinc[..., None]
    corners_l = torch.stack([base - e_u * sz_u + e_v * sz_v,
                             base + e_u * sz_u + e_v * sz_v,
                             base + e_u * sz_u - e_v * sz_v,
                             base - e_u * sz_u - e_v * sz_v], -2)   # (N,4,3)
    corners_w = p_inc[..., None, :] + _mm(corners_l, _T(R_inc))

    ku, kv = (kref + 1) % 3, (kref + 2) % 3
    r_u, r_v, r_k = _onehot(ku, p_ref), _onehot(kv, p_ref), \
        _onehot(kref, p_ref)
    su_ref = _pick(s_ref, ku)
    sv_ref = _pick(s_ref, kv)
    sk_ref = _pick(s_ref, kref)

    lq = _mv(_T(R_ref)[..., None, :, :], corners_w - p_ref[..., None, :])
    q = torch.stack([_pick(lq, ku[..., None].expand(lq.shape[:-1])),
                     _pick(lq, kv[..., None].expand(lq.shape[:-1])),
                     _pick(lq, kref[..., None].expand(lq.shape[:-1]))],
                    -1)                                          # (N, 4, 3)
    quv = q[..., :2]
    e1 = q[..., 1, :] - q[..., 0, :]
    e2 = q[..., 3, :] - q[..., 0, :]
    det_p = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
    plane_ok = det_p.abs() > 1e-12
    det_s = torch.where(plane_ok, det_p, torch.ones_like(det_p))
    az = (e1[..., 2] * e2[..., 1] - e2[..., 2] * e1[..., 1]) / det_s
    bz = (e2[..., 2] * e1[..., 0] - e1[..., 2] * e2[..., 0]) / det_s
    q0 = q[..., 0, :]

    def z_of(uv):                                # incident-face plane height
        x = lambda t: t[..., None]
        return torch.where(x(plane_ok),
                      x(q0[..., 2]) + x(az) * (uv[..., 0] - x(q0[..., 0]))
                      + x(bz) * (uv[..., 1] - x(q0[..., 1])),
                      x(q0[..., 2]))

    bounds = torch.stack([su_ref, sv_ref], -1)                  # (N, 2)
    c_in = (quv.abs() <= bounds[..., None, :] + 1e-12).all(-1)  # (N, 4)
    qi = quv
    d_e = torch.roll(quv, -1, dims=-2) - qi                      # (N, 4, 2)

    def crossings(cidx, bound_c, bound_o):
        """Edge crossings with the two lines coord[cidx] = +-bound_c."""
        den = d_e[..., cidx:cidx + 1]                            # (N, 4, 1)
        ok_den = den.abs() > 1e-13
        den_s = torch.where(ok_den, den, torch.ones_like(den))
        line_b = torch.stack([bound_c, -bound_c], -1)[..., None, :]
        t = (line_b - qi[..., cidx:cidx + 1]) / den_s            # (N, 4, 2)
        pt = qi[..., :, None, :] + t[..., None] * d_e[..., :, None, :]
        ok = (ok_den & (t >= 0.0) & (t <= 1.0)
              & (pt[..., 1 - cidx].abs() <= bound_o[..., None, None]
                 + 1e-12))
        return pt[..., 0, :], pt[..., 1, :], ok[..., 0], ok[..., 1]

    pt_u1, pt_u2, ok_u1, ok_u2 = crossings(0, su_ref, sv_ref)
    pt_v1, pt_v2, ok_v1, ok_v2 = crossings(1, sv_ref, su_ref)
    pu, pv = su_ref, sv_ref
    rc = torch.stack([torch.stack([pu, pv], -1), torch.stack([pu, -pv], -1),
                      torch.stack([-pu, pv], -1),
                      torch.stack([-pu, -pv], -1)], -2)          # (N, 4, 2)
    wind = torch.sign(det_p + 1e-30)
    rel = rc[..., None, :, :] - qi[..., :, None, :]      # (N, edge, corner, 2)
    crz = d_e[..., :, None, 0] * rel[..., 1] - d_e[..., :, None, 1] * rel[..., 0]
    r_in = (crz * wind[..., None, None] >= -1e-12).all(-2) & plane_ok[..., None]

    uv24 = torch.cat([quv, pt_u1, pt_u2, pt_v1, pt_v2, rc], -2)   # (N, 24, 2)
    valid = torch.cat([c_in, ok_u1, ok_u2, ok_v1, ok_v2, r_in], -1)
    z24 = z_of(uv24)
    depth = z24 * sref[..., None] - sk_ref[..., None]
    # A polygon vertex on a clip line appears in two candidate classes:
    # keep only its first occurrence.
    same = ((uv24[..., :, None, :] - uv24[..., None, :, :]) ** 2).sum(-1) \
        < 1e-18
    earlier = torch.tril(torch.ones(24, 24, dtype=torch.bool, device=dev),
                         diagonal=-1)
    dup = (same & earlier & valid[..., None, :]).any(-1)
    valid = valid & ~dup

    lq_pts = r_u[..., None, :] * uv24[..., 0:1] \
        + r_v[..., None, :] * uv24[..., 1:2] + r_k[..., None, :] * z24[..., None]
    pts_w = p_ref[..., None, :] + _mv(R_ref[..., None, :, :], lq_pts)
    pos = pts_w - 0.5 * depth[..., None] * n_world[..., None, :]
    dist = torch.where(valid, depth, torch.full_like(depth, BIG))
    return dist, pos


def box_box(p1, m1, s1, p2, m2, s2, margin):
    """Separating axes (6 faces + 9 edge pairs); a face axis yields the
    face-clipping manifold (24 candidate slots), an edge axis one point."""
    dtype, dev = p1.dtype, p1.device
    R1, R2 = m1, m2
    C = _mm(_T(R1), R2)                   # box2 axes in box1 frame
    pl = _mv(_T(R1), p2 - p1)
    eye = torch.eye(3, dtype=dtype, device=dev)

    best_sep = torch.full_like(pl[..., 0], -BIG)
    best_nl = _e(2, pl).expand(pl.shape)
    best_i = torch.zeros_like(pl[..., 0], dtype=torch.long)

    def consider(idx, sep, nl, st):
        b_sep, b_nl, b_i = st
        better = sep > b_sep
        return (torch.where(better, sep, b_sep),
                torch.where(better[..., None], nl, b_nl),
                torch.where(better, torch.full_like(b_i, idx), b_i))

    st = (best_sep, best_nl, best_i)
    for k in range(3):                     # box1 faces
        rb = _vdot(C[..., k, :].abs(), s2)
        sep = pl[..., k].abs() - s1[..., k] - rb
        st = consider(k, sep, eye[k] * torch.sign(pl[..., k] + 1e-30)[..., None],
                      st)
    for k in range(3):                     # box2 faces
        axis_l = C[..., :, k]
        proj = _vdot(pl, axis_l)
        ra = _vdot(axis_l.abs(), s1)
        sep = proj.abs() - ra - s2[..., k]
        st = consider(3 + k, sep, axis_l * torch.sign(proj + 1e-30)[..., None],
                      st)
    for i in range(3):                     # edge-edge
        for jj in range(3):
            axis = cross(eye[i].expand(pl.shape), C[..., :, jj])
            nlen = norm(axis)
            axis_n = axis / torch.clamp(nlen, min=1e-12)[..., None]
            proj = _vdot(pl, axis_n)
            ra = _vdot(axis_n.abs(), s1)
            rb = _vdot(_mv(_T(C), axis_n).abs(), s2)
            sep = proj.abs() - ra - rb
            sep = torch.where(nlen > 1e-9, sep - 1e-9, torch.full_like(sep, -BIG))
            st = consider(6 + 3 * i + jj, sep,
                          axis_n * torch.sign(proj + 1e-30)[..., None], st)

    sep_best, nl_best, best = st
    n_w = _mv(R1, nl_best)                 # from box1 toward box2
    use_f1 = best < 3
    use_f2 = (best >= 3) & (best < 6)
    d_f1, p_f1 = _box_face_manifold(p1, R1, s1, p2, R2, s2, n_w)
    d_f2, p_f2 = _box_face_manifold(p2, R2, s2, p1, R1, s1, -n_w)

    # Edge-edge: closest points between the two touching edges.
    ei = best - 6
    i_idx = torch.clamp(torch.div(ei, 3, rounding_mode="floor"), 0, 2)
    j_idx = torch.clamp(torch.remainder(ei, 3), 0, 2)
    oh_i = _onehot(i_idx, p1)
    oh_j = _onehot(j_idx, p1)
    dir2_l = _mv(C, oh_j)
    s1_i = _pick(s1, i_idx)[..., None]
    s2_j = _pick(s2, j_idx)[..., None]
    corner1_l = torch.sign(_mv(_T(R1), n_w) + 1e-30) * s1 * (1.0 - oh_i)
    corner2_l = torch.sign(_mv(_T(R2), -n_w) + 1e-30) * s2 * (1.0 - oh_j)
    a1 = p1 + _mv(R1, corner1_l - oh_i * s1_i)
    b1 = p1 + _mv(R1, corner1_l + oh_i * s1_i)
    a2 = p2 + _mv(R2, corner2_l) - _mv(R1, dir2_l * s2_j)
    b2 = p2 + _mv(R2, corner2_l) + _mv(R1, dir2_l * s2_j)
    c1e, c2e, _ = _segment_closest(a1, b1, a2, b2)
    pos_e = 0.5 * (c1e + c2e)
    d_e = torch.full_like(d_f1, BIG)
    d_e[..., 0] = sep_best

    f1, f2 = use_f1[..., None], use_f2[..., None]
    dist = torch.where(f1, d_f1, torch.where(f2, d_f2, d_e))
    pos = torch.where(f1[..., None], p_f1,
                 torch.where(f2[..., None], p_f2,
                        pos_e[..., None, :].expand(p_f1.shape)))
    return dist, pos, n_w[..., None, :].expand(pos.shape)
