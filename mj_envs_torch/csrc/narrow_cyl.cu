// Narrowphase of the four cylinder pair types, one thread per (env, pair)
// instance: plane-cylinder, capsule-cylinder, cylinder-cylinder and
// cylinder-box, each the plain function of
// mj_envs_torch/physics/collision/narrowphase.py computed whole in one
// thread, one launch per pair-type group.
//
// Replaces no TPU kernel.  The JAX package's narrowphase is plain jnp
// code that XLA fuses into a few device programs; PyTorch's eager mode
// launches every op of it, and the iterative cylinder paths (48
// alternating projections and 24 polish steps of the generic convex
// contact, 17 samples and 24 golden-section steps of capsule-cylinder)
// come to ~16,000 launches of ~2 us elementwise kernels a substep on
// hammer, with the device idle while the host issues them.  This kernel
// runs the same fixed trip counts in registers instead.
//
// Bound on the card, hammer-v0 at B = 512 (2, 22, 55 and 3 pairs: 1024
// cylinder-cylinder, 11264 cylinder-box, 28160 capsule-cylinder and 1536
// plane-cylinder instances): operations, but for plane-cylinder.  The
// bytes are each distinct geom's position and frame once per env, the
// sizes and geom ids once, and C candidates of dist, pos and nrm (28 C
// bytes) per instance: 4.1 MB over the four launches, 1.2 us at 3.35
// TB/s.  The operations (adds, multiplies, divides, square roots) of an
// instance on its costliest path, counted from this file: the generic
// convex contact with its set-up, ~8,300 for cylinder-cylinder and
// cylinder-box; capsule-cylinder's 67 point distances of ~50 and its
// contacts, ~3,600; plane-cylinder's rim points, 141.  At 67 TFLOP/s:
// cylinder-box 1.38 us, capsule-cylinder 1.51, cylinder-cylinder 0.13;
// plane-cylinder 0.08 us of bytes (a cap, side, standing or lying
// instance takes a few hundred operations, so these are the most the
// inputs need).  What costs the time is the chain of dependent
// operations within one instance (each projection round has a divide
// and a square root on its chain), with few warps to hide it: 32 for
// cylinder-cylinder's 1024 instances.
//
// Design: one thread computes one instance from its indexed inputs to
// its candidates, every iterate in registers; no shared memory and no
// synchronization.  Only the branch that the plain version's `where`
// selects is computed (cap, side or generic; standing, lying or
// generic): its value is the same.
//
// Arithmetic: narrow.cuh's, op for op the plain version's, so that the
// outputs equal it bit for bit on the card.
//
// nvcc -Xptxas -v (CUDA 12.8, sm_90a), registers: plane-cylinder 40,
// capsule-cylinder 54, cylinder-cylinder 62, cylinder-box 62; each 0
// bytes stack frame, no spills.
#include "narrow.cuh"

namespace {

constexpr float kParallel = static_cast<float>(0.999);
constexpr float kAxial = static_cast<float>(0.999999);
constexpr float kLying = static_cast<float>(1e-3);
constexpr float kShrink = static_cast<float>(0.3);
constexpr float kGolden = static_cast<float>(0.618033988749895);
// sqrt(3)/2 rounded as narrowphase._s3 rounds it in float32
constexpr float kS120 = 0.866025388240814208984375f;  // exact
constexpr float kC120 = -0.5f;

constexpr int kApIters = 48;      // narrowphase.AP_ITERS
constexpr int kPolishIters = 24;  // narrowphase.POLISH_ITERS
constexpr int kGsIters = 24;      // narrowphase.GS_ITERS
constexpr int kSamples = 17;      // capsule_cylinder's samples

// --- the solids of the generic convex contact ------------------------------

struct Cyl {
  V3 c, axis, ortho;   // ortho = _ortho(axis)
  float r, hl;
};

struct Box {
  V3 c;
  M3 m;
  V3 size;
};

// _proj_cyl_solid
__device__ __forceinline__ V3 project(const Cyl& s, V3 x) {
  const V3 rel = x - s.c;
  const float z = dot(rel, s.axis);
  const V3 rad = rel - scale(s.axis, z);
  const float rn = norm(rad);
  const V3 rdir = sel(rn > kEps12, divs(rad, clamp_min(rn, kEps12)), s.ortho);
  return (s.c + scale(s.axis, clip(z, -s.hl, s.hl))) +
         scale(rdir, tmin(rn, s.r));
}

// _proj_box_solid
__device__ __forceinline__ V3 project(const Box& s, V3 x) {
  const V3 l = mvt(s.m, x - s.c);
  const V3 cl = {clip(l.x, -s.size.x, s.size.x),
                 clip(l.y, -s.size.y, s.size.y),
                 clip(l.z, -s.size.z, s.size.z)};
  return s.c + mv(s.m, cl);
}

// _supp_cyl
__device__ __forceinline__ float support(const Cyl& s, V3 d) {
  const float za = dot(d, s.axis);
  const float perp = norm(d - scale(s.axis, za));
  return (dot(d, s.c) + mul(s.hl, fabsf(za))) + mul(s.r, perp);
}

// _supp_box
__device__ __forceinline__ float support(const Box& s, V3 d) {
  const V3 dl = mvt(s.m, d);
  return dot(d, s.c) + dot({fabsf(dl.x), fabsf(dl.y), fabsf(dl.z)}, s.size);
}

// _supp_cyl_grad
__device__ __forceinline__ V3 support_grad(const Cyl& s, V3 d) {
  const float za = dot(d, s.axis);
  const V3 perpv = d - scale(s.axis, za);
  const float h = mul(s.r, dvd(0.5f, norm(perpv)));
  const V3 u = scale(perpv, h) + scale(perpv, h);
  const float sg = za >= 0.0f ? 1.0f : -1.0f;
  const float ct_za = mul(s.hl, sg) - dot(u, s.axis);
  return (s.c + u) + scale(s.axis, ct_za);
}

// _supp_box_grad
__device__ __forceinline__ V3 support_grad(const Box& s, V3 d) {
  const V3 dl = mvt(s.m, d);
  const V3 sg = {dl.x >= 0.0f ? 1.0f : -1.0f, dl.y >= 0.0f ? 1.0f : -1.0f,
                 dl.z >= 0.0f ? 1.0f : -1.0f};
  return s.c + mv(s.m, {mul(sg.x, s.size.x), mul(sg.y, s.size.y),
                        mul(sg.z, s.size.z)});
}

// _supp_point_cyl
__device__ __forceinline__ V3 support_point(const Cyl& s, V3 d, V3 ref) {
  const float za = dot(d, s.axis);
  const V3 perp = d - scale(s.axis, za);
  const float pn = norm(perp);
  const V3 relr = ref - s.c;
  const float zr = dot(relr, s.axis);
  const V3 rad_r = relr - scale(s.axis, zr);
  const V3 pdir = pn > kEps6 ? divs(perp, clamp_min(pn, kEps12))
                             : safe_unit(rad_r, s.ortho);
  const float zc = fabsf(za) > kEps6 ? mul(s.hl, sgn(za))
                                     : clip(zr, -s.hl, s.hl);
  const float rc = fabsf(za) > kAxial ? tmin(norm(rad_r), s.r) : s.r;
  return (s.c + scale(s.axis, zc)) + scale(pdir, rc);
}

// _supp_point_box
__device__ __forceinline__ V3 support_point(const Box& s, V3 d, V3 ref) {
  const V3 dl = mvt(s.m, d);
  const V3 rl = mvt(s.m, ref - s.c);
  auto coord = [&](int i) {
    return fabsf(dl[i]) > kEps6 ? mul(sgn(dl[i]), s.size[i])
                                : clip(rl[i], -s.size[i], s.size[i]);
  };
  return s.c + mv(s.m, {coord(0), coord(1), coord(2)});
}

// _convex_contact: A's solid, B's solid, their pre-shrunk copies for the
// alternating projection, the start point, the fallback normal and the
// K candidate directions.
template <int K, class A, class B>
__device__ __forceinline__ void convex_contact(
    const A& a, const B& b, const A& a_sh, const B& b_sh, V3 x0,
    V3 fallback_n, const V3 (&cands)[K], float& dist, V3& pos, V3& n) {
  V3 x = x0, y = x0;
  for (int it = 0; it < kApIters; ++it) {
    x = project(a_sh, y);
    y = project(b_sh, x);
  }
  const V3 d = y - x;
  const float ln = norm(d);
  V3 nn = sel(ln > kEps10, divs(d, clamp_min(ln, kEps10)), fallback_n);
  auto gap = [&](V3 v) { return -support(b, -v) - support(a, v); };
  const float gap_ap = gap(nn);
  // torch.max over the candidates: the first NaN, else the first largest
  float g_best = gap(cands[0]);
  V3 n_cand = cands[0];
#pragma unroll
  for (int k = 1; k < K; ++k) {
    const float g = gap(cands[k]);
    if (!isnan_(g_best) && (isnan_(g) || g > g_best)) {
      g_best = g;
      n_cand = cands[k];
    }
  }
  nn = sel(g_best > gap_ap, n_cand, nn);
  float gap_best = tmax(g_best, gap_ap);
  V3 n_best = nn;
  float step = 0.25f;
  for (int it = 0; it < kPolishIters; ++it) {
    const V3 grad = support_grad(b, -nn) - support_grad(a, nn);
    const V3 tang = grad - scale(nn, dot(grad, nn));
    V3 n_try = nn + scale(tang, step);
    n_try = divs(n_try, clamp_min(norm(n_try), kEps12));
    const float g_try = gap(n_try);
    if (g_try > gap_best) {
      n_best = n_try;
      gap_best = g_try;
      nn = n_try;
    } else {
      step = mul(step, 0.5f);
    }
  }
  n = n_best;
  dist = gap_best;
  const V3 mid = scale(x + y, 0.5f);
  V3 aw = support_point(a, n, mid);
  const V3 bw = support_point(b, -n, aw);
  aw = support_point(a, n, bw);
  pos = sel(dist > gap_ap + kEps7, scale(aw + bw, 0.5f), mid);
}

// --- the plain functions' helpers -------------------------------------------

// _closest_on_cylinder_surface: the surface point, and whether p is inside
__device__ __forceinline__ V3 closest_on_cylinder_surface(
    V3 p, V3 c, V3 axis, V3 axis_ortho, float r, float hl, bool& inside) {
  const V3 rel = p - c;
  const float z = dot(rel, axis);
  const V3 radial = rel - scale(axis, z);
  const float rn = norm(radial);
  const V3 rdir =
      sel(rn > kEps12, divs(radial, clamp_min(rn, kEps12)), axis_ortho);
  inside = (fabsf(z) <= hl) && (rn <= r);
  if (!inside)
    return (c + scale(axis, clip(z, -hl, hl))) + scale(rdir, tmin(rn, r));
  if (r - rn <= hl - fabsf(z)) return (c + scale(axis, z)) + scale(rdir, r);
  return (c + scale(axis, mul(sgn(z + kTiny), hl))) + scale(rdir, rn);
}

// plane_cylinder: plane through p1 with normal n; the cylinder's centre,
// axis, frame column 0, radius and half length.
__device__ __forceinline__ void plane_cylinder(V3 p1, V3 n, V3 p2, V3 axis,
                                               V3 col0, float r, float hl,
                                               float (&dist)[4],
                                               V3 (&pos)[4]) {
  const float ca = dot(n, axis);
  const V3 prj = scale(axis, ca) - n;
  const float prjn = norm(prj);
  const V3 rad = sel(prjn < kEps10, col0, divs(prj, clamp_min(prjn, kEps12)));
  const V3 cap = p2 + scale(axis, mul(hl, ca < 0.0f ? 1.0f : -1.0f));
  const V3 far_cap = scale(p2, 2.0f) - cap;
  const V3 t2v = cross(axis, rad);
  const V3 pts[4] = {
      cap + scale(rad, r),
      cap + scale(scale(rad, kC120) + scale(t2v, kS120), r),
      cap + scale(scale(rad, kC120) - scale(t2v, kS120), r),
      far_cap + scale(rad, r)};
  const float h = dot(p1, n);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    dist[k] = dot(pts[k], n) - h;
    pos[k] = pts[k] - scale(n, mul(0.5f, dist[k]));
  }
}

// --- the four pair functions ------------------------------------------------

// plane_cylinder (plane geom1, cylinder geom2): 4 candidates
__device__ __forceinline__ void pair_plane_cylinder(
    const Geom& g1, const Geom& g2, float (&dist)[4], V3 (&pos)[4],
    V3 (&nrm)[4]) {
  const V3 n = g1.m.col(2);
  plane_cylinder(g1.p, n, g2.p, g2.m.col(2), g2.m.col(0), g2.s.x, g2.s.y,
                 dist, pos);
#pragma unroll
  for (int k = 0; k < 4; ++k) nrm[k] = n;
}

// capsule_cylinder (capsule geom1, cylinder geom2): 2 candidates
__device__ __forceinline__ void pair_capsule_cylinder(
    const Geom& g1, const Geom& g2, float (&dist)[2], V3 (&pos)[2],
    V3 (&nrm)[2]) {
  const float r1 = g1.s.x, h1 = g1.s.y;
  const V3 ax1 = g1.m.col(2);
  const V3 a = g1.p - scale(ax1, h1);
  const V3 b = g1.p + scale(ax1, h1);
  const V3 ab = b - a;
  const V3 ax2 = g2.m.col(2);
  const V3 ax2_ortho = ortho(ax2);
  const float r2 = g2.s.x, h2 = g2.s.y;

  // point_dist: the signed distance of a + t (b - a), its point and the
  // cylinder's surface point
  auto point_dist = [&](float t, V3& pt, V3& surf) {
    pt = a + scale(ab, t);
    bool inside;
    surf = closest_on_cylinder_surface(pt, g2.p, ax2, ax2_ortho, r2, h2,
                                       inside);
    const float ln = norm(surf - pt);
    return inside ? -ln : ln;
  };
  V3 pt, surf;
  // torch.argmin over the samples t = i / 16: the first NaN, else the
  // first smallest
  float d_min = point_dist(0.0f, pt, surf);
  int i_min = 0;
  for (int i = 1; i < kSamples; ++i) {
    const float d = point_dist(mul(static_cast<float>(i), 0.0625f), pt, surf);
    if (!isnan_(d_min) && (isnan_(d) || d < d_min)) {
      d_min = d;
      i_min = i;
    }
  }
  const float t_i = mul(static_cast<float>(i_min), 0.0625f);
  float lo = clip(t_i - 0.0625f, 0.0f, 1.0f);
  float hi = clip(t_i + 0.0625f, 0.0f, 1.0f);
  for (int it = 0; it < kGsIters; ++it) {
    const float m_lo = hi - mul(kGolden, hi - lo);
    const float m_hi = lo + mul(kGolden, hi - lo);
    const float f_lo = point_dist(m_lo, pt, surf);
    const float f_hi = point_dist(m_hi, pt, surf);
    if (f_lo < f_hi) {
      hi = m_hi;
    } else {
      lo = m_lo;
    }
  }
  const float t_best = mul(0.5f, lo + hi);
  const float dmin = point_dist(t_best, pt, surf);
  const V3 dvec = surf - pt;
  const float ln = norm(dvec);
  const V3 n_out = sel(ln > kEps12, divs(dvec, clamp_min(ln, kEps12)),
                       ax2_ortho);
  const V3 n = sel(dmin < 0.0f, -n_out, n_out);
  dist[0] = dmin - r1;
  pos[0] = scale((pt + scale(n, r1)) + surf, 0.5f);
  nrm[0] = n;

  const bool parallel = fabsf(dot(ax1, ax2)) > kParallel;
  V3 pt2, surf2;
  const float d2 = point_dist(t_best < 0.5f ? 1.0f : 0.0f, pt2, surf2);
  const V3 d2vec = surf2 - pt2;
  const float ln2 = norm(d2vec);
  V3 n2 = sel(ln2 > kEps12, divs(d2vec, clamp_min(ln2, kEps12)), n);
  n2 = sel(d2 < 0.0f, -n2, n2);
  dist[1] = parallel ? d2 - r1 : kBig;
  pos[1] = scale((pt2 + scale(n2, r1)) + surf2, 0.5f);
  nrm[1] = n2;
}

// cylinder_cylinder: 4 candidates
__device__ __forceinline__ void pair_cylinder_cylinder(
    const Geom& g1, const Geom& g2, float (&dist)[4], V3 (&pos)[4],
    V3 (&nrm)[4]) {
  const float r1 = g1.s.x, h1 = g1.s.y, r2 = g2.s.x, h2 = g2.s.y;
  const V3 p1 = g1.p, p2 = g2.p;
  const V3 ax1 = g1.m.col(2), ax2 = g2.m.col(2);
  const V3 ax1_ortho = ortho(ax1);

  const bool parallel = fabsf(dot(ax1, ax2)) > kParallel;
  const V3 rel = p2 - p1;
  const float z = dot(rel, ax1);
  const V3 radial = rel - scale(ax1, z);
  const float rn = norm(radial);
  const V3 rdir =
      sel(rn > kEps12, divs(radial, clamp_min(rn, kEps12)), ax1_ortho);
  const float axial_gap = fabsf(z) - (h1 + h2);
  const float radial_gap = rn - (r1 + r2);
  const bool cap_case = parallel && (rn < tmax(r1, r2));

  if (cap_case) {  // cap-cap ring: 3 points at 120 deg and the centre
    const V3 n_cc = scale(ax1, sgn(z + kTiny));
    const float ring_r = tmin(r1, r2);
    const V3 t1v = ax1_ortho;
    const V3 t2v = cross(ax1, t1v);
    const V3 ring_c =
        r1 < r2 ? p1 + scale(n_cc, h1 + mul(0.5f, axial_gap))
                : p2 - scale(n_cc, h2 + mul(0.5f, axial_gap));
    pos[0] = ring_c + scale(t1v, ring_r);
    pos[1] = ring_c + scale(scale(t1v, kC120) + scale(t2v, kS120), ring_r);
    pos[2] = ring_c + scale(scale(t1v, kC120) - scale(t2v, kS120), ring_r);
    pos[3] = ring_c;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      dist[k] = axial_gap;
      nrm[k] = n_cc;
    }
    return;
  }

  const float z2lo = z - h2, z2hi = z + h2;
  const float lo = tmax(-h1, tmin(z2lo, z2hi));
  const float hi = tmin(h1, tmax(z2lo, z2hi));
  if (parallel && hi > lo) {  // side by side: a 2-point line
    const float mid = mul(0.5f, lo + hi);
    const float pts_ax[4] = {lo, hi, mid, mid};
    const V3 out1 = scale(rdir, r1);
    const V3 across = scale(rdir, radial_gap);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const V3 surf1 = (p1 + scale(ax1, pts_ax[k])) + out1;
      const V3 surf2 = surf1 + across;
      pos[k] = scale(surf1 + surf2, 0.5f);
      nrm[k] = rdir;
    }
    dist[0] = dist[1] = radial_gap;
    dist[2] = dist[3] = kBig;
    return;
  }

  // generic: the convex contact between the solids
  const V3 a1 = p1 - scale(ax1, h1), b1 = p1 + scale(ax1, h1);
  const V3 a2 = p2 - scale(ax2, h2), b2 = p2 + scale(ax2, h2);
  V3 c1, c2;
  segment_closest(a1, b1, a2, b2, c1, c2);
  const float shrink = mul(kShrink, tmin(tmin(r1, h1), tmin(r2, h2)));
  const V3 cr = safe_unit(cross(ax1, ax2), rdir);
  const V3 cands[8] = {rdir, -rdir, ax1, -ax1, ax2, -ax2, cr, -cr};
  const Cyl A{p1, ax1, ax1_ortho, r1, h1};
  const Cyl B{p2, ax2, ortho(ax2), r2, h2};
  const Cyl A_sh{p1, ax1, A.ortho, r1 - shrink, h1 - shrink};
  const Cyl B_sh{p2, ax2, B.ortho, r2 - shrink, h2 - shrink};
  float d;
  V3 p, n;
  convex_contact(A, B, A_sh, B_sh, scale(c1 + c2, 0.5f), rdir, cands, d, p,
                 n);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    dist[k] = k == 0 ? d : kBig;
    pos[k] = p;
    nrm[k] = n;
  }
}

// cylinder_box (cylinder geom1, box geom2): 4 candidates
__device__ __forceinline__ void pair_cylinder_box(
    const Geom& g1, const Geom& g2, float (&dist)[4], V3 (&pos)[4],
    V3 (&nrm)[4]) {
  const float r = g1.s.x, hl = g1.s.y;
  const V3 p1 = g1.p, p2 = g2.p, s2 = g2.s;
  const V3 ax = g1.m.col(2);
  const M3& m2 = g2.m;

  const V3 rel_l = mvt(m2, p1 - p2);
  // torch.argmax: the first NaN, else the first largest
  int k = 0;
  float best = dvd(fabsf(rel_l.x), s2.x);
#pragma unroll
  for (int i = 1; i < 3; ++i) {
    const float v = dvd(fabsf(rel_l[i]), s2[i]);
    if (!isnan_(best) && (isnan_(v) || v > best)) {
      best = v;
      k = i;
    }
  }
  const float sg = sgn(rel_l[k] + kTiny);
  const V3 ohk = {k == 0 ? 1.0f : 0.0f, k == 1 ? 1.0f : 0.0f,
                  k == 2 ? 1.0f : 0.0f};
  const V3 face_n = mv(m2, scale(ohk, sg));   // outward
  const V3 face_c = p2 + scale(face_n, s2[k]);
  const float ca = dot(face_n, ax);

  bool stand_valid = true;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    stand_valid = stand_valid && (i == k || fabsf(rel_l[i]) <= s2[i] + r);
  if (fabsf(ca) > kParallel && stand_valid) {  // standing: cap on the face
    float dpc[4];
    V3 ppc[4];
    plane_cylinder(face_c, face_n, p1, ax, g1.m.col(0), r, hl, dpc, ppc);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const V3 pl = mvt(m2, ppc[c] - p2);
      auto cl = [&](int i) {
        return i == k ? pl[i] : clip(pl[i], -s2[i], s2[i]);
      };
      dist[c] = dpc[c];
      pos[c] = p2 + mv(m2, {cl(0), cl(1), cl(2)});
      nrm[c] = -face_n;
    }
    return;
  }

  // lying: the axis segment clipped against the face rectangle
  const V3 a = p1 - scale(ax, hl);
  const V3 b = p1 + scale(ax, hl);
  const V3 al = mvt(m2, a - p2);
  const V3 dl2 = mvt(m2, b - p2) - al;
  float t_lo = 0.0f, t_hi = 1.0f;
  bool ly_ok = true;
#pragma unroll
  for (int dim = 0; dim < 3; ++dim) {
    const bool is_face = k == dim;
    const bool par = fabsf(dl2[dim]) < kEps12;
    const float safe = par ? 1.0f : dl2[dim];
    const float t1 = dvd(-s2[dim] - al[dim], safe);
    const float t2 = dvd(s2[dim] - al[dim], safe);
    if (!(is_face || par)) {
      t_lo = tmax(t_lo, tmin(t1, t2));
      t_hi = tmin(t_hi, tmax(t1, t2));
    }
    ly_ok = ly_ok && (!(par && !is_face) || fabsf(al[dim]) <= s2[dim]);
  }
  ly_ok = ly_ok && (t_lo <= t_hi);
  if (fabsf(ca) < kLying && ly_ok) {
    const V3 ba = b - a;
    V3 pa = a + scale(ba, t_lo);
    V3 pb = b + scale(ba, t_hi - 1.0f);
    const float da = dot(pa - face_c, face_n) - r;
    const float db = dot(pb - face_c, face_n) - r;
    const float d_shared = tmin(da, db);
    const V3 push = scale(face_n, r + mul(0.5f, d_shared));
    pa = pa - push;
    pb = pb - push;
    dist[0] = dist[1] = d_shared;
    dist[2] = dist[3] = kBig;
    pos[0] = pos[2] = pa;
    pos[1] = pos[3] = pb;
#pragma unroll
    for (int c = 0; c < 4; ++c) nrm[c] = -face_n;
    return;
  }

  // generic: the convex contact between the solids
  // s2.min(-1): the first NaN, else the smallest
  float s_min = s2.x;
#pragma unroll
  for (int i = 1; i < 3; ++i)
    if (!isnan_(s_min) && (isnan_(s2[i]) || s2[i] < s_min)) s_min = s2[i];
  const float shrink = mul(kShrink, tmin(tmin(r, hl), s_min));
  const V3 rel_cb = safe_unit(p2 - p1, -face_n);
  const V3 c0 = m2.col(0), c1 = m2.col(1), c2 = m2.col(2);
  const V3 cands[10] = {rel_cb, -rel_cb, ax, -ax, c0, -c0, c1, -c1, c2, -c2};
  const Cyl A{p1, ax, ortho(ax), r, hl};
  const Box B{p2, m2, s2};
  const Cyl A_sh{p1, ax, A.ortho, r - shrink, hl - shrink};
  const Box B_sh{p2, m2, {s2.x - shrink, s2.y - shrink, s2.z - shrink}};
  float d;
  V3 p, n;
  convex_contact(A, B, A_sh, B_sh, scale(p1 + p2, 0.5f), -face_n, cands, d,
                 p, n);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    dist[c] = c == 0 ? d : kBig;
    pos[c] = p;
    nrm[c] = n;
  }
}

// --- the entry points ---------------------------------------------------------

// Each reads no margin.
struct PlaneCylinder {
  static constexpr int C = 4;
  __device__ static void run(const Geom& g1, const Geom& g2, float,
                             const Out& out) {
    float d[C];
    V3 p[C], n[C];
    pair_plane_cylinder(g1, g2, d, p, n);
    out.put_all(d, p, n);
  }
};

struct CapsuleCylinder {
  static constexpr int C = 2;
  __device__ static void run(const Geom& g1, const Geom& g2, float,
                             const Out& out) {
    float d[C];
    V3 p[C], n[C];
    pair_capsule_cylinder(g1, g2, d, p, n);
    out.put_all(d, p, n);
  }
};

struct CylinderCylinder {
  static constexpr int C = 4;
  __device__ static void run(const Geom& g1, const Geom& g2, float,
                             const Out& out) {
    float d[C];
    V3 p[C], n[C];
    pair_cylinder_cylinder(g1, g2, d, p, n);
    out.put_all(d, p, n);
  }
};

struct CylinderBox {
  static constexpr int C = 4;
  __device__ static void run(const Geom& g1, const Geom& g2, float,
                             const Out& out) {
    float d[C];
    V3 p[C], n[C];
    pair_cylinder_box(g1, g2, d, p, n);
    out.put_all(d, p, n);
  }
};

}  // namespace

NARROW_ENTRY(narrow_plane_cylinder, PlaneCylinder)
NARROW_ENTRY(narrow_capsule_cylinder, CapsuleCylinder)
NARROW_ENTRY(narrow_cylinder_cylinder, CylinderCylinder)
NARROW_ENTRY(narrow_cylinder_box, CylinderBox)
