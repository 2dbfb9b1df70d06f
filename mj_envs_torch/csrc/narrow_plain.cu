// Narrowphase of the five plain pair types, one thread per (env, pair)
// instance: plane-capsule, plane-box, capsule-capsule, capsule-box and
// box-box, each the plain function of
// mj_envs_torch/physics/collision/narrowphase.py computed whole in one
// thread, one launch per pair-type group.  A file of its own beside
// narrow_cyl.cu, sharing narrow.cuh, so that nvcc builds the two in
// parallel.
//
// Replaces no TPU kernel.  The JAX package's narrowphase is plain jnp
// code that XLA fuses into a few device programs; PyTorch's eager mode
// launches every op of it: ~1,600 small elementwise and reduce kernels a
// substep on hammer for these five groups (box-box's 15 separating axes
// and two 24-slot face clippings alone ~980), with the device idle while
// the host issues them, and 22 host syncs (the groups' index uploads,
// `_e`'s one-hot vectors, plane-box's sign table).  This kernel computes
// the same values in registers instead.
//
// Bound on the card, hammer-v0 at B = 512 (2, 2, 52, 99 and 20 pairs:
// 1024 plane-capsule, 1024 plane-box, 26624 capsule-capsule, 50688
// capsule-box and 10240 box-box instances): bytes, for each of the five.
// The bytes are each distinct geom's position and frame once per env, the
// sizes, geom ids and margins once, and C candidates of dist, pos and nrm
// (28 C bytes) per instance: 13.0 MB over the five launches, 3.9 us at
// 3.35 TB/s, box-box's 24 slots 7.1 MB of it (2.11 us).  The operations
// (adds, multiplies, divides, square roots) of an instance on its
// costliest path, counted from this file: box-box 3,650 (15 separating
// axes 654, one face clipping 2,996 of which the 276-pair duplicate test
// 1,380), capsule-box 572 (the 12-step fixed point 180, three sphere-box
// contacts ~100 each), plane-box 277, capsule-capsule 206, plane-capsule
// 44; at 67 TFLOP/s box-box's are 0.56 us, under its bytes.  Measured
// (CUDA events, a real 512-env hammer chunk, NVIDIA H100 80GB HBM3 at
// 700 W): box-box 0.0475 ms (22x its bound), capsule-box 0.0077 (7.4x),
// capsule-capsule 0.0041 (7.1x), plane-box 0.0054, plane-capsule 0.0025
// (a launch each); what holds them is the chain of dependent operations
// within one instance with few warps to hide it (box-box's 10240
// instances are 320 warps on 132 SMs) and each thread's scattered stores
// of its C slots, not the memory system.
//
// Design: one thread computes one instance from its indexed inputs to
// its candidates; no shared memory and no synchronization.  Only the
// branch that the plain version's `where` selects is computed: box-box's
// face 1, face 2 or edge (the one face clipping, with the reference and
// incident boxes chosen before it, not both), capsule-box's fallback
// contact only where it is used.  Box-box writes each of its 24 slots as
// soon as the slot is done, keeping of the earlier slots only their
// (u, v) points and valid bits for the duplicate test, unrolled with
// constant indices so that they stay in registers: it fits one thread
// (below), so it needs no warp per instance with a lane per candidate.
//
// nvcc -Xptxas -v (CUDA 12.8, sm_90a), registers: box-box 153,
// capsule-box 59, capsule-capsule 48, plane-box 40, plane-capsule 32;
// each 0 bytes stack frame, no spills.
//
// Arithmetic: narrow.cuh's, op for op the plain version's, so that the
// outputs equal it bit for bit on the card.
#include "narrow.cuh"

namespace {

constexpr float kEps9 = static_cast<float>(1e-9);
constexpr float kEps13 = static_cast<float>(1e-13);
constexpr float kEps15 = static_cast<float>(1e-15);
constexpr float kEps18 = static_cast<float>(1e-18);

constexpr int kFixedPointIters = 12;  // capsule_box's clamp projection

__device__ __forceinline__ V3 absv(V3 a) {
  return {fabsf(a.x), fabsf(a.y), fabsf(a.z)};
}
// _onehot: row k of the identity
__device__ __forceinline__ V3 onehot(int k) {
  return {k == 0 ? 1.0f : 0.0f, k == 1 ? 1.0f : 0.0f, k == 2 ? 1.0f : 0.0f};
}
// torch.argmax / torch.argmin over an axis of 3: the first NaN, else the
// first largest / smallest
__device__ __forceinline__ int argmax3(V3 v) {
  int k = 0;
  float best = v.x;
#pragma unroll
  for (int i = 1; i < 3; ++i) {
    if (!isnan_(best) && (isnan_(v[i]) || v[i] > best)) {
      best = v[i];
      k = i;
    }
  }
  return k;
}
__device__ __forceinline__ int argmin3(V3 v) {
  int k = 0;
  float best = v.x;
#pragma unroll
  for (int i = 1; i < 3; ++i) {
    if (!isnan_(best) && (isnan_(v[i]) || v[i] < best)) {
      best = v[i];
      k = i;
    }
  }
  return k;
}

// _closest_on_segment
__device__ __forceinline__ V3 closest_on_segment(V3 a, V3 b, V3 p) {
  const V3 ab = b - a;
  const float t = clip(dvd(dot(p - a, ab), clamp_min(dot(ab, ab), kEps15)),
                       0.0f, 1.0f);
  return a + scale(ab, t);
}

// _closest_on_box: the closest point on the solid box (c, m, size) to p's
// surface, and whether p is inside (then pushed out through the nearest
// face)
__device__ __forceinline__ V3 closest_on_box(V3 p, const Geom& box,
                                             bool& inside) {
  const V3 size = box.s;
  const V3 lp = mvt(box.m, p - box.p);
  const V3 clamped = {clip(lp.x, -size.x, size.x), clip(lp.y, -size.y, size.y),
                      clip(lp.z, -size.z, size.z)};
  inside = fabsf(lp.x) <= size.x && fabsf(lp.y) <= size.y &&
           fabsf(lp.z) <= size.z;
  if (!inside) return box.p + mv(box.m, clamped);
  const int k = argmin3(size - absv(lp));
  const V3 oh = onehot(k);
  const float push = mul(sgn(lp[k] + kTiny), size[k]);
  const V3 proj = {mul(clamped.x, 1.0f - oh.x) + mul(oh.x, push),
                   mul(clamped.y, 1.0f - oh.y) + mul(oh.y, push),
                   mul(clamped.z, 1.0f - oh.z) + mul(oh.z, push)};
  return box.p + mv(box.m, proj);
}

// _sphere_point_box: a sphere of radius r at pt against the box
__device__ __forceinline__ void sphere_point_box(V3 pt, float r,
                                                 const Geom& box, float& dist,
                                                 V3& pos, V3& n) {
  bool inside;
  const V3 surf = closest_on_box(pt, box, inside);
  const V3 d = surf - pt;
  const float ln = norm(d);
  n = sel(ln > kEps12, divs(d, clamp_min(ln, kEps12)), V3{0.0f, 0.0f, 1.0f});
  if (inside) n = -n;
  dist = (inside ? -ln : ln) - r;
  pos = scale((pt + scale(n, r)) + surf, 0.5f);
}

// --- the five pair functions ------------------------------------------------

// plane_capsule (plane geom1, capsule geom2): 2 candidates
struct PlaneCapsule {
  static constexpr int C = 2;
  __device__ static void run(const Geom& g1, const Geom& g2, float,
                             const Out& out) {
    const V3 n = g1.m.col(2);
    const float r = g2.s.x;
    const V3 half = scale(g2.m.col(2), g2.s.y);
    const V3 ends[2] = {g2.p + half, g2.p - half};
    const float h = dot(g1.p, n);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float dist = (dot(ends[k], n) - h) - r;
      out.put(k, dist, ends[k] - scale(n, r + mul(0.5f, dist)), n);
    }
  }
};

// plane_box (plane geom1, box geom2): its 8 corners
struct PlaneBox {
  static constexpr int C = 8;
  __device__ static void run(const Geom& g1, const Geom& g2, float,
                             const Out& out) {
    const V3 n = g1.m.col(2);
    const float h = dot(g1.p, n);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // narrowphase._BOX_SIGNS[i] times the half sizes
      const V3 half = {mul((i >> 2) & 1 ? 1.0f : -1.0f, g2.s.x),
                       mul((i >> 1) & 1 ? 1.0f : -1.0f, g2.s.y),
                       mul(i & 1 ? 1.0f : -1.0f, g2.s.z)};
      const V3 corner = g2.p + mv(g2.m, half);
      const float dist = dot(corner, n) - h;
      out.put(i, dist, corner - scale(n, mul(0.5f, dist)), n);
    }
  }
};

// capsule_capsule: the closest-point contact, and a second at the other
// end of the overlap interval of (near-)parallel capsules
struct CapsuleCapsule {
  static constexpr int C = 2;
  __device__ static void run(const Geom& g1, const Geom& g2, float,
                             const Out& out) {
    const float r1 = g1.s.x, h1 = g1.s.y, r2 = g2.s.x, h2 = g2.s.y;
    const V3 ax1 = g1.m.col(2), ax2 = g2.m.col(2);
    const V3 a1 = g1.p - scale(ax1, h1), b1 = g1.p + scale(ax1, h1);
    const V3 a2 = g2.p - scale(ax2, h2), b2 = g2.p + scale(ax2, h2);
    V3 c1, c2;
    const bool parallel = segment_closest(a1, b1, a2, b2, c1, c2);
    const V3 d = c2 - c1;
    const float ln = norm(d);
    const V3 n = ln > kEps12 ? divs(d, clamp_min(ln, kEps12)) : ortho(ax1);
    out.put(0, (ln - r1) - r2,
            scale((c1 + scale(n, r1)) + (c2 - scale(n, r2)), 0.5f), n);

    const float t_a2 = dot(a2 - a1, ax1);
    const float t_b2 = dot(b2 - a1, ax1);
    const float lo = clamp_min(tmin(t_a2, t_b2), 0.0f);
    const float hi = tmin(mul(2.0f, h1), tmax(t_a2, t_b2));
    const float t_first = dot(c1 - a1, ax1);
    const float t_other =
        fabsf(t_first - lo) > fabsf(t_first - hi) ? lo : hi;
    const V3 c1b = a1 + scale(ax1, t_other);
    const V3 c2b = closest_on_segment(a2, b2, c1b);
    const V3 db = c2b - c1b;
    const float lnb = norm(db);
    const V3 nb = sel(lnb > kEps12, divs(db, clamp_min(lnb, kEps12)), n);
    const bool valid_b =
        parallel && hi > lo && fabsf(t_other - t_first) > kEps9;
    out.put(1, valid_b ? (lnb - r1) - r2 : kBig,
            scale((c1b + scale(nb, r1)) + (c2b - scale(nb, r2)), 0.5f), nb);
  }
};

// capsule_box (capsule geom1, box geom2): the axis segment clipped against
// the supporting face's slab, a sphere-box contact at each clip end; the
// segment's closest point (a 12-step clamp projection) on a miss, or
// where neither end lies within the pair's margin
struct CapsuleBox {
  static constexpr int C = 2;
  __device__ static void run(const Geom& g1, const Geom& g2, float margin,
                             const Out& out) {
    const float r = g1.s.x, hl = g1.s.y;
    const V3 ax = g1.m.col(2);
    const V3 a = g1.p - scale(ax, hl), b = g1.p + scale(ax, hl);
    const V3 s2 = g2.s;
    const V3 al = mvt(g2.m, a - g2.p);
    const V3 dl = mvt(g2.m, b - g2.p) - al;
    const V3 rel = absv(mvt(g2.m, g1.p - g2.p));
    const int kf = argmax3({dvd(rel.x, s2.x), dvd(rel.y, s2.y),
                            dvd(rel.z, s2.z)});

    float t_lo = 0.0f, t_hi = 1.0f;
    bool miss = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const bool is_face = kf == k;
      const bool par = fabsf(dl[k]) < kEps13;
      const float safe = par ? 1.0f : dl[k];
      const float t1 = dvd(-s2[k] - al[k], safe);
      const float t2 = dvd(s2[k] - al[k], safe);
      if (!(is_face || par)) {
        t_lo = tmax(t_lo, tmin(t1, t2));
        t_hi = tmin(t_hi, tmax(t1, t2));
      }
      miss = miss || (par && !is_face && fabsf(al[k]) > s2[k] + r);
    }
    miss = miss || t_lo > t_hi;
    float t_a = tmin(clamp_min(t_lo, 0.0f), t_hi);
    const float t_b = tmin(clamp_min(t_lo, 1.0f), t_hi);

    float t_fp = 0.5f;
    const float dd = clamp_min(dot(dl, dl), kEps15);
    for (int it = 0; it < kFixedPointIters; ++it) {
      const V3 at = al + scale(dl, t_fp);
      const V3 cl = {clip(at.x, -s2.x, s2.x), clip(at.y, -s2.y, s2.y),
                     clip(at.z, -s2.z, s2.z)};
      t_fp = clip(dvd(dot(cl - al, dl), dd), 0.0f, 1.0f);
    }
    if (miss) t_a = t_fp;

    float dist_a, dist_b;
    V3 pos_a, pos_b, n_a, n_b;
    sphere_point_box(g2.p + mv(g2.m, al + scale(dl, t_a)), r, g2, dist_a,
                     pos_a, n_a);
    sphere_point_box(g2.p + mv(g2.m, al + scale(dl, t_b)), r, g2, dist_b,
                     pos_b, n_b);
    if (miss) dist_b = kBig;
    if (miss || (dist_a >= margin && dist_b >= margin)) {
      sphere_point_box(g2.p + mv(g2.m, al + scale(dl, t_fp)), r, g2, dist_a,
                       pos_a, n_a);
      dist_b = kBig;
    }
    out.put(0, dist_a, pos_a, n_a);
    out.put(1, dist_b, pos_b, n_b);
  }
};

// _box_face_manifold: the incident box's face against the reference
// face's rectangle, n_world from the reference box toward the incident
// one; all 24 candidates of the intersection polygon (incident corners in
// the rectangle, edge crossings of its four lines, rectangle corners in
// the quad), each written with the normal `nrm`, invalid ones at +BIG.
__device__ __forceinline__ void box_face_manifold(const Geom& ref,
                                                  const Geom& inc,
                                                  V3 n_world, V3 nrm,
                                                  const Out& out) {
  const V3 nl_ref = mvt(ref.m, n_world);
  const int kref = argmax3(absv(nl_ref));
  const float sref = sgn(nl_ref[kref] + kTiny);
  const V3 nl_inc = mvt(inc.m, n_world);
  const int kinc = argmax3(absv(nl_inc));
  const float sinc = -sgn(nl_inc[kinc] + kTiny);

  // the incident face's corners, in the reference face's (u, v, k) axes
  const int kiu = (kinc + 1) % 3, kiv = (kinc + 2) % 3;
  const V3 e_u = onehot(kiu), e_v = onehot(kiv);
  const V3 base = scale(scale(onehot(kinc), inc.s[kinc]), sinc);
  const V3 eu = scale(e_u, inc.s[kiu]), ev = scale(e_v, inc.s[kiv]);
  const V3 corners_l[4] = {(base - eu) + ev, (base + eu) + ev,
                           (base + eu) - ev, (base - eu) - ev};
  const int ku = (kref + 1) % 3, kv = (kref + 2) % 3;
  const float su = ref.s[ku], sv = ref.s[kv], sk = ref.s[kref];
  V3 q[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const V3 lq = mvt(ref.m, (inc.p + mv(inc.m, corners_l[c])) - ref.p);
    q[c] = {lq[ku], lq[kv], lq[kref]};
  }
  const V3 e1 = q[1] - q[0], e2 = q[3] - q[0];
  const float det_p = mul(e1.x, e2.y) - mul(e1.y, e2.x);
  const bool plane_ok = fabsf(det_p) > kEps12;
  const float det_s = plane_ok ? det_p : 1.0f;
  const float az = dvd(mul(e1.z, e2.y) - mul(e2.z, e1.y), det_s);
  const float bz = dvd(mul(e2.z, e1.x) - mul(e1.z, e2.x), det_s);
  float de[4][2];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    de[c][0] = q[(c + 1) % 4].x - q[c].x;
    de[c][1] = q[(c + 1) % 4].y - q[c].y;
  }
  const float wind = sgn(det_p + kTiny);
  const V3 r_u = onehot(ku), r_v = onehot(kv), r_k = onehot(kref);

  // Slots: 0-3 the incident corners, 4-7 / 8-11 the edges' crossings of
  // u = +su / -su, 12-15 / 16-19 of v = +sv / -sv, 20-23 the rectangle's
  // corners (+-su, +-sv).
  float uv[24][2];
  bool valid[24];
#pragma unroll
  for (int s = 0; s < 24; ++s) {
    float u, v;
    bool ok;
    if (s < 4) {
      u = q[s].x;
      v = q[s].y;
      ok = fabsf(u) <= su + kEps12 && fabsf(v) <= sv + kEps12;
    } else if (s < 20) {
      const int cidx = s < 12 ? 0 : 1;            // the line's coordinate
      const int c = (s - 4) % 4;                  // the edge
      const bool neg = ((s - 4) / 4) % 2 == 1;    // the line at -bound
      const float bound_c = cidx == 0 ? su : sv;
      const float bound_o = cidx == 0 ? sv : su;
      const float qc = cidx == 0 ? q[c].x : q[c].y;
      const float den = de[c][cidx];
      const bool ok_den = fabsf(den) > kEps13;
      const float t = dvd((neg ? -bound_c : bound_c) - qc,
                          ok_den ? den : 1.0f);
      u = q[c].x + mul(t, de[c][0]);
      v = q[c].y + mul(t, de[c][1]);
      ok = ok_den && t >= 0.0f && t <= 1.0f &&
           fabsf(cidx == 0 ? v : u) <= bound_o + kEps12;
    } else {
      u = s < 22 ? su : -su;
      v = s % 2 == 0 ? sv : -sv;
      ok = plane_ok;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float crz = mul(de[e][0], v - q[e].y) - mul(de[e][1], u - q[e].x);
        ok = ok && mul(crz, wind) >= -kEps12;
      }
    }
    uv[s][0] = u;
    uv[s][1] = v;
    valid[s] = ok;
    // a polygon vertex on a clip line appears in two classes: keep only
    // its first occurrence
    bool dup = false;
#pragma unroll
    for (int t = 0; t < s; ++t) {
      const float du = u - uv[t][0], dv = v - uv[t][1];
      dup = dup || (valid[t] && mul(du, du) + mul(dv, dv) < kEps18);
    }
    const float z = plane_ok ? (q[0].z + mul(az, u - q[0].x)) +
                                   mul(bz, v - q[0].y)
                             : q[0].z;
    const float depth = mul(z, sref) - sk;
    const V3 lq_pts = (scale(r_u, u) + scale(r_v, v)) + scale(r_k, z);
    const V3 pts_w = ref.p + mv(ref.m, lq_pts);
    out.put(s, ok && !dup ? depth : kBig,
            pts_w - scale(n_world, mul(0.5f, depth)), nrm);
  }
}

// box_box: separating axes (box 1's faces, box 2's, the 9 edge pairs);
// a face axis gives the face-clipping manifold, an edge axis one point
struct BoxBox {
  static constexpr int C = 24;
  __device__ static void run(const Geom& g1, const Geom& g2, float,
                             const Out& out) {
    const M3& R1 = g1.m;
    const M3& R2 = g2.m;
    const V3 s1 = g1.s, s2 = g2.s;
    M3 Cm;   // box 2's axes in box 1's frame, _mm(_T(R1), R2)
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        Cm.m[i][j] = sum3t(mul(R1.m[0][i], R2.m[0][j]),
                           mul(R1.m[1][i], R2.m[1][j]),
                           mul(R1.m[2][i], R2.m[2][j]));
    const V3 pl = mvt(R1, g2.p - g1.p);

    float best_sep = -kBig;
    V3 best_nl = {0.0f, 0.0f, 1.0f};
    int best = 0;
    auto consider = [&](int idx, float sep, V3 nl) {
      if (sep > best_sep) {
        best_sep = sep;
        best_nl = nl;
        best = idx;
      }
    };
#pragma unroll
    for (int k = 0; k < 3; ++k) {   // box 1's faces
      const float sep = (fabsf(pl[k]) - s1[k]) - dot(absv(Cm.row(k)), s2);
      consider(k, sep, scale(onehot(k), sgn(pl[k] + kTiny)));
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {   // box 2's faces
      const V3 axis_l = Cm.col(k);
      const float proj = dot(pl, axis_l);
      const float sep = (fabsf(proj) - dot(absv(axis_l), s1)) - s2[k];
      consider(3 + k, sep, scale(axis_l, sgn(proj + kTiny)));
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {   // edge-edge
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) {
        const V3 axis = cross(onehot(i), Cm.col(jj));
        const float nlen = norm(axis);
        const V3 axis_n = divs(axis, clamp_min(nlen, kEps12));
        const float proj = dot(pl, axis_n);
        const float sep = (fabsf(proj) - dot(absv(axis_n), s1)) -
                          dot(absv(mvt(Cm, axis_n)), s2);
        consider(6 + 3 * i + jj, nlen > kEps9 ? sep - kEps9 : -kBig,
                 scale(axis_n, sgn(proj + kTiny)));
      }
    }

    const V3 n_w = mv(R1, best_nl);   // from box 1 toward box 2
    if (best < 3) {
      box_face_manifold(g1, g2, n_w, n_w, out);
      return;
    }
    if (best < 6) {
      box_face_manifold(g2, g1, -n_w, n_w, out);
      return;
    }
    // edge-edge: the closest points of the two touching edges
    const int i = (best - 6) / 3, j = (best - 6) % 3;
    const V3 oh_i = onehot(i), oh_j = onehot(j);
    const V3 dir2_l = mv(Cm, oh_j);
    const V3 u1 = mvt(R1, n_w), u2 = mvt(R2, -n_w);
    const V3 corner1_l = {mul(mul(sgn(u1.x + kTiny), s1.x), 1.0f - oh_i.x),
                          mul(mul(sgn(u1.y + kTiny), s1.y), 1.0f - oh_i.y),
                          mul(mul(sgn(u1.z + kTiny), s1.z), 1.0f - oh_i.z)};
    const V3 corner2_l = {mul(mul(sgn(u2.x + kTiny), s2.x), 1.0f - oh_j.x),
                          mul(mul(sgn(u2.y + kTiny), s2.y), 1.0f - oh_j.y),
                          mul(mul(sgn(u2.z + kTiny), s2.z), 1.0f - oh_j.z)};
    const V3 half1 = scale(oh_i, s1[i]);
    const V3 a1 = g1.p + mv(R1, corner1_l - half1);
    const V3 b1 = g1.p + mv(R1, corner1_l + half1);
    const V3 mid2 = g2.p + mv(R2, corner2_l);
    const V3 half2 = mv(R1, scale(dir2_l, s2[j]));
    V3 c1, c2;
    segment_closest(a1, b1, mid2 - half2, mid2 + half2, c1, c2);
    const V3 pos = scale(c1 + c2, 0.5f);
    out.put(0, best_sep, pos, n_w);
#pragma unroll
    for (int c = 1; c < C; ++c) out.put(c, kBig, pos, n_w);
  }
};

}  // namespace

NARROW_ENTRY(narrow_plane_capsule, PlaneCapsule)
NARROW_ENTRY(narrow_plane_box, PlaneBox)
NARROW_ENTRY(narrow_capsule_capsule, CapsuleCapsule)
NARROW_ENTRY(narrow_capsule_box, CapsuleBox)
NARROW_ENTRY(narrow_box_box, BoxBox)
