// Exact Newton linesearch on the piecewise-quadratic constraint cost,
// returning the step alpha and the summed row cost at alpha.
//
// Replaces mj_envs_tpu/physics/kernels.py:_linesearch_cost_kernel
// (_linesearch_cost_pallas, with the search of _linesearch_alpha_vals):
// 12 bracket doublings of phi'(alpha), then 16 safeguarded
// Newton/bisection steps, then one cost pass at the final alpha.
//
// Bound on the card: memory, barely.  The inputs are 4 float rows and
// one bool row per env (nefc = 296 on hammer-v0, 2.6 MB at B = 512) and
// the search makes 12 + 2 * 16 + 1 = 45 passes of ~8 flops per row over
// them (~53 Mflop), so either bound is about a microsecond.  What costs
// time is the chain of 45 dependent reductions per env.
//
// Design: one warp per env.  Each lane keeps its rows (at most PER of
// them, row = lane + 32 * i) in registers for the whole search, so the
// rows are read from device memory once; every phi'/phi'' evaluation is
// a register pass plus a butterfly warp-shuffle sum that leaves the
// total in every lane.  No shared memory and no block barriers: the
// branch decisions are warp-uniform because every lane holds the same
// reduced values.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int PER>
__global__ void linesearch_cost_kernel(
    const float* __restrict__ jar_g, const float* __restrict__ Jp_g,
    const float* __restrict__ D_g, const float* __restrict__ floss_g,
    const uint8_t* __restrict__ active_g, const float* __restrict__ c1_g,
    const float* __restrict__ c2_g, float* __restrict__ alpha_out,
    float* __restrict__ cost_out, int B, int R, int bracket_iters,
    int ls_iters) {
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

  // phi'(alpha) = c1 + alpha c2 - sum f(jar + alpha Jp) Jp
  auto dphi = [&](float alpha) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float ja = jar[i] + alpha * Jp[i];
      const float fq = -D[i] * ja;
      const float ffric = fminf(fmaxf(fq, -fl[i]), fl[i]);
      const float fone = ja < 0.0f ? fq : 0.0f;
      const float f = (fl[i] > 0.0f ? ffric : fone) * act[i];
      s += f * Jp[i];
    }
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

  float hi = 1.0f;
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

  // Row cost at the final alpha (solver._cost_rows, active rows only).
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const float ja = jar[i] + alpha * Jp[i];
    const float quad_cost = 0.5f * D[i] * ja * ja;
    const float lin_cost =
        fl[i] * fabsf(ja) - 0.5f * (fl[i] * fl[i]) / fmaxf(D[i], 1e-30f);
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

template <int PER>
int launch(const float* jar, const float* Jp, const float* D,
           const float* floss, const uint8_t* active, const float* c1,
           const float* c2, float* alpha, float* cost, int B, int R,
           int bracket_iters, int ls_iters, cudaStream_t stream) {
  constexpr int kWarps = 4;
  const int blocks = (B + kWarps - 1) / kWarps;
  if (blocks > 0)
    linesearch_cost_kernel<PER><<<blocks, 32 * kWarps, 0, stream>>>(
        jar, Jp, D, floss, active, c1, c2, alpha, cost, B, R, bracket_iters,
        ls_iters);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaErrorInvalidValue when R exceeds 32 * 32 rows.
extern "C" int linesearch_cost(const float* jar, const float* Jp,
                               const float* D, const float* floss,
                               const uint8_t* active, const float* c1,
                               const float* c2, float* alpha, float* cost,
                               int B, int R, int bracket_iters, int ls_iters,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int per = (R + 31) / 32;
  if (per <= 4)
    return launch<4>(jar, Jp, D, floss, active, c1, c2, alpha, cost, B, R,
                     bracket_iters, ls_iters, s);
  if (per <= 10)
    return launch<10>(jar, Jp, D, floss, active, c1, c2, alpha, cost, B, R,
                      bracket_iters, ls_iters, s);
  if (per <= 16)
    return launch<16>(jar, Jp, D, floss, active, c1, c2, alpha, cost, B, R,
                      bracket_iters, ls_iters, s);
  if (per <= 32)
    return launch<32>(jar, Jp, D, floss, active, c1, c2, alpha, cost, B, R,
                      bracket_iters, ls_iters, s);
  return (int)cudaErrorInvalidValue;
}
