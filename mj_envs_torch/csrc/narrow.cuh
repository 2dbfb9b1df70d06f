// The narrowphase kernels' shared arithmetic, instance layout and launch:
// narrow_cyl.cu (the four cylinder pair types) and narrow_plain.cu (the
// five plain ones) each compute a plain pair function of
// mj_envs_torch/physics/collision/narrowphase.py for one (env, pair)
// instance in one thread, one launch per pair-type group.
//
// Arithmetic: the plain version's, op for op, so that the outputs equal
// it bit for bit on the card.  Every multiply is __fmul_rn, so that no
// product is contracted into an FMA; divides and square roots are the
// IEEE ones PyTorch uses (__fdiv_rn, __fsqrt_rn).  A sum over an axis of
// 3 adds in the order PyTorch's CUDA reduction does, which follows the
// layout of the summed product: (x0 + x2) + x1 where the summed axis is
// the product's innermost in memory (two lanes per output, lane 0
// holding x0 and x2; `sum3`), (x0 + x1) + x2 where another axis is
// (one thread per output, summing in order; `sum3t`).  The second is
// the case of `_mv(_T(m), v)` and of `_mm(_T(a), b)`, whose products
// TensorIterator lays out after the transposed frame; `_mv(m, v)`,
// `_vdot`, `norm` and `_mm(a, _T(m))` sum innermost.  maximum, minimum
// and clamp propagate NaN as torch's do; sign(NaN) is 0 as torch.sign's
// is; argmax and argmin take the first NaN, else the first extreme
// index.  Python float constants are the double rounded to float, as
// PyTorch rounds a scalar operand.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float kBig = 1e10f;
constexpr float kEps6 = static_cast<float>(1e-6);
constexpr float kEps7 = static_cast<float>(1e-7);
constexpr float kEps10 = static_cast<float>(1e-10);
constexpr float kEps12 = static_cast<float>(1e-12);
constexpr float kEps14 = static_cast<float>(1e-14);
constexpr float kTiny = static_cast<float>(1e-30);

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

// A sum over an innermost axis of 3, and over any other (the head).
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

// _segment_closest: the closest points c1, c2; returns `parallel`
__device__ __forceinline__ bool segment_closest(V3 a1, V3 b1, V3 a2, V3 b2,
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
  return denom <= mul(mul(A, kEps10), e);
}

struct Geom {
  V3 p;
  M3 m;
  V3 s;   // size
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

// One instance's C candidates: slot c goes to dist[o + c] and
// pos / nrm[(o + c) * 3 + i], o = instance * C, the plain version's order.
struct Out {
  float* dist;
  float* pos;
  float* nrm;
  size_t o;
  __device__ __forceinline__ void put(int c, float d, V3 p, V3 n) const {
    const size_t k = o + c;
    dist[k] = d;
    pos[3 * k] = p.x;
    pos[3 * k + 1] = p.y;
    pos[3 * k + 2] = p.z;
    nrm[3 * k] = n.x;
    nrm[3 * k + 1] = n.y;
    nrm[3 * k + 2] = n.z;
  }
  template <int N>
  __device__ __forceinline__ void put_all(const float (&d)[N],
                                          const V3 (&p)[N],
                                          const V3 (&n)[N]) const {
#pragma unroll
    for (int c = 0; c < N; ++c) put(c, d[c], p[c], n[c]);
  }
};

// ---- kernels and C entry points ------------------------------------------

constexpr int kThreads = 64;

// Instance idx = b * P + p of the group: geom ids g1[p], g2[p] and the
// pair's margin[p]; Pair::run computes its Pair::C candidates.
template <class Pair>
__global__ void __launch_bounds__(kThreads) narrow_kernel(
    const float* __restrict__ xpos, const float* __restrict__ xmat,
    const float* __restrict__ size, int size_bstride,
    const int* __restrict__ g1, const int* __restrict__ g2,
    const float* __restrict__ margin, int n, int P, int ngeom,
    float* __restrict__ dist, float* __restrict__ pos,
    float* __restrict__ nrm) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  const int b = idx / P, p = idx - b * P;
  const Geom geom1 = load_geom(xpos, xmat, size, b, g1[p], ngeom,
                               size_bstride);
  const Geom geom2 = load_geom(xpos, xmat, size, b, g2[p], ngeom,
                               size_bstride);
  Pair::run(geom1, geom2, margin[p],
            Out{dist, pos, nrm, (size_t)idx * Pair::C});
}

template <class Pair>
int launch(const float* xpos, const float* xmat, const float* size,
           int size_bstride, const int* g1, const int* g2,
           const float* margin, int B, int P, int ngeom, float* dist,
           float* pos, float* nrm, void* stream) {
  const int n = B * P;
  if (n <= 0) return 0;
  narrow_kernel<Pair><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        (cudaStream_t)stream>>>(
      xpos, xmat, size, size_bstride, g1, g2, margin, n, P, ngeom, dist, pos,
      nrm);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry: geom_xpos (B, ngeom, 3), geom_xmat (B, ngeom, 3, 3) and
// geom_size (ngeom, 3) shared (size_bstride 0) or (B, ngeom, 3) per env
// (size_bstride ngeom * 3), float32; the group's geom ids g1, g2 (P,)
// int32 and pair margins (P,) float32; dist (B, P * C), pos and nrm
// (B, P * C, 3) float32.
#define NARROW_ENTRY(name, Pair)                                             \
  extern "C" int name(const float* xpos, const float* xmat,                  \
                      const float* size, int size_bstride, const int* g1,    \
                      const int* g2, const float* margin, int B, int P,      \
                      int ngeom, float* dist, float* pos, float* nrm,        \
                      void* stream) {                                        \
    return launch<Pair>(xpos, xmat, size, size_bstride, g1, g2, margin, B,   \
                        P, ngeom, dist, pos, nrm, stream);                   \
  }
