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
// Arithmetic: the plain version's, op for op, so that the outputs equal
// it bit for bit on the card.  Every multiply is __fmul_rn, so that no
// product is contracted into an FMA; divides and square roots are the
// IEEE ones PyTorch uses (__fdiv_rn, __fsqrt_rn).  A sum over a last
// axis of 3 adds in the order PyTorch's CUDA reduction does: (x0 + x2)
// + x1 where that axis is contiguous in the summed product (two lanes
// per output, lane 0 holding x0 and x2), (x0 + x1) + x2 where the
// product follows a transposed frame (`_mv(_T(m), v)`, one thread per
// output).  maximum, minimum and clamp propagate NaN as torch's do;
// sign(NaN) is 0 as torch.sign's is; argmax and argmin take the first
// NaN, else the first extreme index.  Python float constants are the
// double rounded to float, as PyTorch rounds a scalar operand.
//
// nvcc -Xptxas -v (CUDA 12.8, sm_90a), registers: plane-cylinder 40,
// capsule-cylinder 54, cylinder-cylinder 62, cylinder-box 62; each 0
// bytes stack frame, no spills.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e10f;
constexpr float kEps6 = static_cast<float>(1e-6);
constexpr float kEps7 = static_cast<float>(1e-7);
constexpr float kEps10 = static_cast<float>(1e-10);
constexpr float kEps12 = static_cast<float>(1e-12);
constexpr float kEps14 = static_cast<float>(1e-14);
constexpr float kTiny = static_cast<float>(1e-30);
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

struct V3 {
  float x, y, z;
  __device__ __forceinline__ float operator[](int i) const {
    return i == 0 ? x : (i == 1 ? y : z);
  }
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ bool isnan_(float a) { return a != a; }
// torch.maximum / torch.minimum: NaN if either is
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan_(a) ? a : (isnan_(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan_(a) ? a : (isnan_(b) ? b : fminf(a, b));
}
// torch.clamp(x, min=lo) with a scalar lo
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan_(x) ? x : fmaxf(x, lo);
}
// narrowphase._clip and torch.clamp(x, lo, hi)
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return tmin(tmax(x, lo), hi);
}
__device__ __forceinline__ float sgn(float x) {
  return static_cast<float>((0.0f < x) - (x < 0.0f));
}

__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return {mul(a.x, s), mul(a.y, s), mul(a.z, s)};
}
__device__ __forceinline__ V3 divs(V3 a, float s) {
  return {dvd(a.x, s), dvd(a.y, s), dvd(a.z, s)};
}
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }

// A sum over a contiguous last axis of 3, and over a transposed frame's.
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return (x0 + x2) + x1;
}
__device__ __forceinline__ float sum3t(float x0, float x1, float x2) {
  return (x0 + x1) + x2;
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return sum3(mul(a.x, b.x), mul(a.y, b.y), mul(a.z, b.z));
}
__device__ __forceinline__ float norm(V3 a) { return __fsqrt_rn(dot(a, a)); }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {mul(a.y, b.z) - mul(a.z, b.y), mul(a.z, b.x) - mul(a.x, b.z),
          mul(a.x, b.y) - mul(a.y, b.x)};
}

// A row-major 3x3 frame (geom_xmat); column 2 is a geom's axis.
struct M3 {
  float m[3][3];
  __device__ __forceinline__ V3 col(int j) const {
    return {m[0][j], m[1][j], m[2][j]};
  }
  __device__ __forceinline__ V3 row(int i) const {
    return {m[i][0], m[i][1], m[i][2]};
  }
};

// _mv(m, v) and _mv(_T(m), v)
__device__ __forceinline__ V3 mv(const M3& a, V3 v) {
  return {dot(a.row(0), v), dot(a.row(1), v), dot(a.row(2), v)};
}
__device__ __forceinline__ float mvt_row(const M3& a, V3 v, int i) {
  return sum3t(mul(a.m[0][i], v.x), mul(a.m[1][i], v.y), mul(a.m[2][i], v.z));
}
__device__ __forceinline__ V3 mvt(const M3& a, V3 v) {
  return {mvt_row(a, v, 0), mvt_row(a, v, 1), mvt_row(a, v, 2)};
}

__device__ __forceinline__ V3 ortho(V3 v) {
  const V3 other = fabsf(v.x) < 0.5f ? V3{1.0f, 0.0f, 0.0f}
                                     : V3{0.0f, 1.0f, 0.0f};
  const V3 w = cross(v, other);
  return divs(w, norm(w));
}

__device__ __forceinline__ V3 safe_unit(V3 v, V3 fallback) {
  const float ln = norm(v);
  return sel(ln > kEps10, divs(v, clamp_min(ln, kEps10)), fallback);
}

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

// _segment_closest: the closest points c1, c2 (its `parallel` is unused
// by the cylinder pairs)
__device__ __forceinline__ void segment_closest(V3 a1, V3 b1, V3 a2, V3 b2,
                                                V3& c1, V3& c2) {
  const V3 d1 = b1 - a1;
  const V3 d2 = b2 - a2;
  const V3 r = a1 - a2;
  const float A = dot(d1, d1);
  const float e = dot(d2, d2);
  const float f = dot(d2, r);
  const float c = dot(d1, r);
  const float b = dot(d1, d2);
  const float denom = mul(A, e) - mul(b, b);
  const float s = denom > kEps14
                      ? clip(dvd(mul(b, f) - mul(c, e),
                                 clamp_min(denom, kEps14)), 0.0f, 1.0f)
                      : 0.0f;
  const float t = dvd(mul(b, s) + f, clamp_min(e, kEps14));
  const float t_cl = clip(t, 0.0f, 1.0f);
  const float s2c = clip(dvd(mul(b, t_cl) - c, clamp_min(A, kEps14)), 0.0f,
                         1.0f);
  c1 = a1 + scale(d1, s2c);
  c2 = a2 + scale(d2, t_cl);
}

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

struct Geom {
  V3 p;
  M3 m;
  V3 s;   // size
};

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

// --- one instance: read by geom index, write in the plain version's order --

enum PairType { kPlaneCylinder, kCapsuleCylinder, kCylinderCylinder,
                kCylinderBox };

template <int T>
struct Slots {
  static constexpr int value = T == kCapsuleCylinder ? 2 : 4;
};

__device__ __forceinline__ Geom load_geom(const float* xpos, const float* xmat,
                                          const float* size, int b, int g,
                                          int ngeom, int size_bstride) {
  Geom out;
  const float* p = xpos + ((size_t)b * ngeom + g) * 3;
  const float* m = xmat + ((size_t)b * ngeom + g) * 9;
  const float* s = size + (size_t)b * size_bstride + (size_t)g * 3;
  out.p = {p[0], p[1], p[2]};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out.m.m[i][j] = m[3 * i + j];
  out.s = {s[0], s[1], s[2]};
  return out;
}

// Instance idx = b * P + p of the group: geom ids g1[p], g2[p]; its C
// candidates go to dist[idx * C + c], pos / nrm[(idx * C + c) * 3 + i].
template <int T>
__device__ __forceinline__ void run_instance(
    int idx, const float* xpos, const float* xmat, const float* size,
    int size_bstride, const int* g1, const int* g2, int P, int ngeom,
    float* dist, float* pos, float* nrm) {
  constexpr int C = Slots<T>::value;
  const int b = idx / P, p = idx - (idx / P) * P;
  const Geom geom1 = load_geom(xpos, xmat, size, b, g1[p], ngeom,
                               size_bstride);
  const Geom geom2 = load_geom(xpos, xmat, size, b, g2[p], ngeom,
                               size_bstride);
  float d[C];
  V3 ps[C], ns[C];
  if constexpr (T == kPlaneCylinder) {
    pair_plane_cylinder(geom1, geom2, d, ps, ns);
  } else if constexpr (T == kCapsuleCylinder) {
    pair_capsule_cylinder(geom1, geom2, d, ps, ns);
  } else if constexpr (T == kCylinderCylinder) {
    pair_cylinder_cylinder(geom1, geom2, d, ps, ns);
  } else {
    pair_cylinder_box(geom1, geom2, d, ps, ns);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const size_t o = (size_t)idx * C + c;
    dist[o] = d[c];
    pos[3 * o] = ps[c].x;
    pos[3 * o + 1] = ps[c].y;
    pos[3 * o + 2] = ps[c].z;
    nrm[3 * o] = ns[c].x;
    nrm[3 * o + 1] = ns[c].y;
    nrm[3 * o + 2] = ns[c].z;
  }
}

// ---- kernels and C entry points ------------------------------------------

constexpr int kThreads = 64;

template <int T>
__global__ void __launch_bounds__(kThreads) narrow_cyl_kernel(
    const float* __restrict__ xpos, const float* __restrict__ xmat,
    const float* __restrict__ size, int size_bstride,
    const int* __restrict__ g1, const int* __restrict__ g2, int n, int P,
    int ngeom, float* __restrict__ dist, float* __restrict__ pos,
    float* __restrict__ nrm) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  run_instance<T>(idx, xpos, xmat, size, size_bstride, g1, g2, P, ngeom, dist,
                  pos, nrm);
}

template <int T>
int launch(const float* xpos, const float* xmat, const float* size,
           int size_bstride, const int* g1, const int* g2, int B, int P,
           int ngeom, float* dist, float* pos, float* nrm, void* stream) {
  const int n = B * P;
  if (n <= 0) return 0;
  narrow_cyl_kernel<T><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         (cudaStream_t)stream>>>(
      xpos, xmat, size, size_bstride, g1, g2, n, P, ngeom, dist, pos, nrm);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry: geom_xpos (B, ngeom, 3), geom_xmat (B, ngeom, 3, 3) and
// geom_size (ngeom, 3) shared (size_bstride 0) or (B, ngeom, 3) per env
// (size_bstride ngeom * 3), float32; the group's geom ids g1, g2 (P,)
// int32; dist (B, P * C), pos and nrm (B, P * C, 3) float32.
#define NARROW_ENTRY(name, type)                                             \
  extern "C" int name(const float* xpos, const float* xmat,                  \
                      const float* size, int size_bstride, const int* g1,    \
                      const int* g2, int B, int P, int ngeom, float* dist,   \
                      float* pos, float* nrm, void* stream) {                \
    return launch<type>(xpos, xmat, size, size_bstride, g1, g2, B, P, ngeom, \
                        dist, pos, nrm, stream);                             \
  }

NARROW_ENTRY(narrow_plane_cylinder, kPlaneCylinder)
NARROW_ENTRY(narrow_capsule_cylinder, kCapsuleCylinder)
NARROW_ENTRY(narrow_cylinder_cylinder, kCylinderCylinder)
NARROW_ENTRY(narrow_cylinder_box, kCylinderBox)
