// Exact Newton linesearch on the piecewise-quadratic constraint cost,
// returning the step alpha and, in the fused form, the summed row cost
// at alpha.
//
// Replaces two TPU kernels of mj_envs_tpu/physics/kernels.py, one
// template instantiated for each, and a third instance kept as their
// reference:
//   linesearch_cost <- _linesearch_cost_kernel (_linesearch_cost_pallas)
//   linesearch      <- _linesearch_kernel      (_linesearch_pallas)
//   linesearch_seq     the sequential search, no TPU kernel: only the
//                      bit-for-bit checks call it (chip_smoke.py phase 3,
//                      tests/test_torch_cuda.py), never a front end
// All run the search of _linesearch_alpha_vals: 12 bracket doublings of
// phi'(alpha), then 16 safeguarded Newton/bisection steps; the fused
// form with the cost adds one cost pass at the final alpha.
//
// Bound on the card: operations, barely.  The inputs are 4 float rows
// and one bool row per env (nefc = 296 on hammer-v0, 2.6 MB at B = 512)
// and the search makes 12 + 2 * 16 + 1 = 45 passes of ~8 flops per row
// over them (~55 Mflop), so either bound is under a microsecond.  What
// costs time is the chain of dependent warp reductions per env: one warp
// per env is 512 warps at B = 512 for 528 SM sub-partitions, with
// nothing to hide a reduction's latency.
//
// Design: one warp per env.  Each lane keeps its rows (at most PER of
// them, row = lane + 32 * i) in registers for the whole search, so the
// rows are read from device memory once; every phi'/phi'' evaluation is
// a register pass plus a butterfly warp-shuffle sum that leaves the
// total in every lane.  No shared memory and no block barriers: the
// branch decisions are warp-uniform because every lane holds the same
// reduced values.
//
// The fused search (linesearch_cost, K5, and linesearch, K7, which stops
// before the cost pass) cuts the chain from 45 dependent reductions to at
// most 18, with each value computed as the sequential search computes it
// (the same row terms, the same per-lane order, the same butterfly), so
// that its alpha is linesearch_seq's bit for bit:
// - the 12 bracket doublings become one pass: phi' at 2^0 .. 2^11 in 12
//   accumulators with 12 interleaved butterflies, then hi = 2^m for the
//   first m whose phi' is not < 0 (the doubling loop's result exactly:
//   once its test fails hi stays; a NaN fails it too);
// - a Newton step takes phi' and phi'' at its alpha in one pass, two
//   butterflies interleaved;
// - a step that leaves (lo, hi, alpha) unchanged bit for bit would be
//   repeated by every later step, so the search stops there (the step
//   count can be written out).  The safeguarded search usually ends in
//   bisections between neighbouring floats, so most envs run all 16.
// - the curvature term selects its factor without a branch: the
//   sequential `fl > 0 ? |fq| <= fl : ja < 0` compiles to a branch and a
//   reconvergence point per row, divergent across the lanes, which made
//   a sequential Newton step cost several bracket rounds;
// - the cost pass gives lin_cost's divide the dividend 1 on rows without
//   friction loss (where it is not used), since a zero dividend sends
//   the IEEE divide down its slow path, a call per row.
// The selected values, and so every sum, are the sequential search's.
// linesearch_seq keeps that search, one reduction per evaluation, as it
// ran in linesearch before the fused form took that name.
// Contraction: the row terms are written once (jar + alpha Jp, s += f
// Jp), so nvcc fuses them into the same FMAs in every instance.
//
// nvcc -Xptxas -v (CUDA 12.8, sm_90a), registers (the fused search takes
// phi' at 12 points per pass up to PER = 16 rows a lane, at 6 for
// PER = 32):
//   PER                4    10    16    32
//   linesearch_cost   56    96   128   255
//   linesearch        56    96   128   255
//   linesearch_seq    40    90   116   213
//   each: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

// The search each instance runs: the fused search with the cost pass
// (linesearch_cost, K5), without it (linesearch, K7), or the sequential
// search (linesearch_seq, the reference both equal).
enum class Search { kFusedCost, kFused, kSequential };

template <int PER, Search MODE>
__global__ void linesearch_kernel(
    const float* __restrict__ jar_g, const float* __restrict__ Jp_g,
    const float* __restrict__ D_g, const float* __restrict__ floss_g,
    const uint8_t* __restrict__ active_g, const float* __restrict__ c1_g,
    const float* __restrict__ c2_g, float* __restrict__ alpha_out,
    float* __restrict__ cost_out, int* __restrict__ steps_out, int B, int R,
    int bracket_iters, int ls_iters) {
  const int lane = threadIdx.x & 31;
  const int env = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (env >= B) return;  // warp-uniform
  const size_t off = (size_t)env * R;

  float jar[PER], Jp[PER], D[PER], fl[PER], act[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int r = lane + 32 * i;
    const bool in = r < R;
    jar[i] = in ? jar_g[off + r] : 0.0f;
    Jp[i] = in ? Jp_g[off + r] : 0.0f;
    D[i] = in ? D_g[off + r] : 0.0f;
    fl[i] = in ? floss_g[off + r] : 0.0f;
    act[i] = (in && active_g[off + r]) ? 1.0f : 0.0f;
  }
  const float c1 = c1_g[env];
  const float c2 = c2_g[env];

  // Row i's force at alpha, f(jar + alpha Jp), of
  // phi'(alpha) = c1 + alpha c2 - sum f Jp; one expression for every mode.
  auto force = [&](float alpha, int i) {
    const float ja = jar[i] + alpha * Jp[i];
    const float fq = -D[i] * ja;
    const float ffric = fminf(fmaxf(fq, -fl[i]), fl[i]);
    const float fone = ja < 0.0f ? fq : 0.0f;
    return (fl[i] > 0.0f ? ffric : fone) * act[i];
  };

  float hi = 1.0f;
  if (MODE == Search::kSequential) {
    // The sequential search, one reduction per evaluation: the bracket
    // doubles hi while phi'(hi) < 0, then each Newton step reduces phi'
    // and then phi''.
    auto dphi = [&](float alpha) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < PER; ++i) s += force(alpha, i) * Jp[i];
      return c1 + alpha * c2 - warp_sum(s);
    };
    // phi''(alpha) = c2 + sum [row quadratic at alpha] D Jp^2
    auto ddphi = [&](float alpha) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const float ja = jar[i] + alpha * Jp[i];
        const float fq = -D[i] * ja;
        const bool quad = fl[i] > 0.0f ? fabsf(fq) <= fl[i] : ja < 0.0f;
        s += (quad ? act[i] : 0.0f) * D[i] * Jp[i] * Jp[i];
      }
      return c2 + warp_sum(s);
    };
    for (int it = 0; it < bracket_iters; ++it)
      if (dphi(hi) < 0.0f) hi *= 2.0f;
    float lo = 0.0f;
    float alpha = fminf(hi, 1.0f);
    for (int it = 0; it < ls_iters; ++it) {
      const float d1 = dphi(alpha);
      const float d2 = ddphi(alpha);
      if (d1 < 0.0f) lo = alpha; else hi = alpha;
      const float a_newton = alpha - d1 / fmaxf(d2, 1e-30f);
      const bool inside = (a_newton > lo) && (a_newton < hi);
      alpha = inside ? a_newton : 0.5f * (lo + hi);
    }
    if (lane == 0) alpha_out[env] = alpha;
    return;
  }

  // The fused curvature term, the same value as the sequential one's:
  // row i's term of phi''(alpha) = c2 + sum [row quadratic] D Jp^2.  The
  // sequential `fl > 0 ? |fq| <= fl : ja < 0` compiles to a branch with a
  // reconvergence point per row, divergent across the lanes; both tests
  // are taken here and the factor selected, without a branch.
  auto curv = [&](float alpha, int i) {
    const float ja = jar[i] + alpha * Jp[i];
    const float fq = -D[i] * ja;
    const float q_fric = fabsf(fq) <= fl[i] ? act[i] : 0.0f;
    const float q_one = ja < 0.0f ? act[i] : 0.0f;
    return (fl[i] > 0.0f ? q_fric : q_one) * D[i] * Jp[i] * Jp[i];
  };

  // The fused search.  The doubling loop ends at hi = 2^m, m the first
  // k < bracket_iters with !(phi'(2^k) < 0), else 2^bracket_iters: once
  // the test fails, hi stays and each later iteration repeats it.  So
  // phi' is taken at NPT powers of two at once, each with the same row
  // order and butterfly as the sequential search's (bit for bit its
  // value), NPT accumulators in one register pass.
  constexpr int NPT = PER <= 16 ? 12 : 6;
  for (int k0 = 0; k0 < bracket_iters; k0 += NPT) {   // hi = 2^k0
    float s[NPT];
#pragma unroll
    for (int p = 0; p < NPT; ++p) s[p] = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i)
#pragma unroll
      for (int p = 0; p < NPT; ++p)
        s[p] += force(hi * (float)(1 << p), i) * Jp[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int p = 0; p < NPT; ++p)
        s[p] += __shfl_xor_sync(0xffffffffu, s[p], o);
    int m = NPT;
#pragma unroll
    for (int p = NPT - 1; p >= 0; --p) {
      const float a = hi * (float)(1 << p);
      if (k0 + p < bracket_iters && !(c1 + a * c2 - s[p] < 0.0f)) m = p;
    }
    if (m < NPT) {       // warp-uniform
      hi *= (float)(1 << m);
      break;
    }
    const int n = bracket_iters - k0 < NPT ? bracket_iters - k0 : NPT;
    hi *= (float)(1 << n);
  }
  // Newton steps, phi' and phi'' in one pass with two butterflies.  A
  // step that leaves (lo, hi, alpha) as they were, bit for bit, would be
  // repeated by every later one: the search stops there.
  float lo = 0.0f;
  float alpha = fminf(hi, 1.0f);
  int steps = 0;
  while (steps < ls_iters) {
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      s1 += force(alpha, i) * Jp[i];
      s2 += curv(alpha, i);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float d1 = c1 + alpha * c2 - s1;
    const float d2 = c2 + s2;
    const float lo_n = d1 < 0.0f ? alpha : lo;
    const float hi_n = d1 < 0.0f ? hi : alpha;
    const float a_newton = alpha - d1 / fmaxf(d2, 1e-30f);
    const bool inside = (a_newton > lo_n) && (a_newton < hi_n);
    const float a_n = inside ? a_newton : 0.5f * (lo_n + hi_n);
    const bool still = same_bits(lo_n, lo) && same_bits(hi_n, hi) &&
                       same_bits(a_n, alpha);
    lo = lo_n;
    hi = hi_n;
    alpha = a_n;
    ++steps;
    if (still) break;    // warp-uniform
  }
  if (steps_out != nullptr && lane == 0) steps_out[env] = steps;
  if (MODE == Search::kFused) {
    if (lane == 0) alpha_out[env] = alpha;
    return;
  }
  // Row cost at the final alpha (solver._cost_rows, active rows only).
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const float ja = jar[i] + alpha * Jp[i];
    const float quad_cost = 0.5f * D[i] * ja * ja;
    // lin_cost is used on friction rows (fl > 0) only; elsewhere its
    // divide gets the dividend 1, since fl = 0 would send the IEEE
    // divide down its slow path.
    const float half_fl2 = fl[i] > 0.0f ? 0.5f * (fl[i] * fl[i]) : 1.0f;
    const float lin_cost = fl[i] * fabsf(ja) - half_fl2 / fmaxf(D[i], 1e-30f);
    const float fric_cost = fabsf(D[i] * ja) <= fl[i] ? quad_cost : lin_cost;
    const float one_cost = ja < 0.0f ? quad_cost : 0.0f;
    s += (fl[i] > 0.0f ? fric_cost : one_cost) * act[i];
  }
  const float cost = warp_sum(s);
  if (lane == 0) {
    alpha_out[env] = alpha;
    cost_out[env] = cost;
  }
}

template <int PER, Search MODE>
int launch(const float* jar, const float* Jp, const float* D,
           const float* floss, const uint8_t* active, const float* c1,
           const float* c2, float* alpha, float* cost, int* steps, int B,
           int R, int bracket_iters, int ls_iters, cudaStream_t stream) {
  constexpr int kWarps = 4;
  const int blocks = (B + kWarps - 1) / kWarps;
  if (blocks > 0)
    linesearch_kernel<PER, MODE><<<blocks, 32 * kWarps, 0, stream>>>(
        jar, Jp, D, floss, active, c1, c2, alpha, cost, steps, B, R,
        bracket_iters, ls_iters);
  return (int)cudaGetLastError();
}

template <Search MODE>
int dispatch(const float* jar, const float* Jp, const float* D,
             const float* floss, const uint8_t* active, const float* c1,
             const float* c2, float* alpha, float* cost, int* steps, int B,
             int R, int bracket_iters, int ls_iters, cudaStream_t s) {
  const int per = (R + 31) / 32;
  if (per <= 4)
    return launch<4, MODE>(jar, Jp, D, floss, active, c1, c2, alpha, cost,
                           steps, B, R, bracket_iters, ls_iters, s);
  if (per <= 10)
    return launch<10, MODE>(jar, Jp, D, floss, active, c1, c2, alpha, cost,
                            steps, B, R, bracket_iters, ls_iters, s);
  if (per <= 16)
    return launch<16, MODE>(jar, Jp, D, floss, active, c1, c2, alpha, cost,
                            steps, B, R, bracket_iters, ls_iters, s);
  if (per <= 32)
    return launch<32, MODE>(jar, Jp, D, floss, active, c1, c2, alpha, cost,
                            steps, B, R, bracket_iters, ls_iters, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each returns cudaErrorInvalidValue when R exceeds 32 * 32 rows.
// linesearch_cost writes the Newton steps each env ran to `steps` unless
// it is null.
extern "C" int linesearch_cost(const float* jar, const float* Jp,
                               const float* D, const float* floss,
                               const uint8_t* active, const float* c1,
                               const float* c2, float* alpha, float* cost,
                               int* steps, int B, int R, int bracket_iters,
                               int ls_iters, void* stream) {
  return dispatch<Search::kFusedCost>(jar, Jp, D, floss, active, c1, c2,
                                      alpha, cost, steps, B, R, bracket_iters,
                                      ls_iters, (cudaStream_t)stream);
}

extern "C" int linesearch(const float* jar, const float* Jp, const float* D,
                          const float* floss, const uint8_t* active,
                          const float* c1, const float* c2, float* alpha,
                          int B, int R, int bracket_iters, int ls_iters,
                          void* stream) {
  return dispatch<Search::kFused>(jar, Jp, D, floss, active, c1, c2, alpha,
                                  nullptr, nullptr, B, R, bracket_iters,
                                  ls_iters, (cudaStream_t)stream);
}

extern "C" int linesearch_seq(const float* jar, const float* Jp,
                              const float* D, const float* floss,
                              const uint8_t* active, const float* c1,
                              const float* c2, float* alpha, int B, int R,
                              int bracket_iters, int ls_iters, void* stream) {
  return dispatch<Search::kSequential>(jar, Jp, D, floss, active, c1, c2,
                                       alpha, nullptr, nullptr, B, R,
                                       bracket_iters, ls_iters,
                                       (cudaStream_t)stream);
}
