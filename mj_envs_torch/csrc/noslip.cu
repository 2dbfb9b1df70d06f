// Noslip post-pass: projected Gauss-Seidel in residual form over the
// friction rows of one env (R = 33 dof-friction rows + 3 * 32 contact
// pairs = 129 on hammer-v0).
//
// Replaces mj_envs_tpu/physics/kernels.py:_noslip_kernel (_noslip_pallas).
// Update order is that of _noslip_scan: for each sweep, for k = 0..R-1,
//   du = -r[k] / a_safe[k];  u_new = clip(u[k] + du, lo[k], hi[k]);
//   du_act = gate[k] > 0 ? u_new - u[k] : 0;
//   r[:] += A[:, k] * du_act;  u[k] += du_act.
//
// Bound on the card: memory by the roofline count (A is R*R floats,
// 66.6 KB per env, 34 MB at B = 512; 20 sweeps are 2*20*R^2 ~ 0.67 Mflop
// per env), but the real limit is the dependency chain of 20 * R
// strictly sequential row updates per env.
//
// Design: one block per env with R threads rounded up to whole warps.
// A sits in dynamic shared memory for all sweeps (read from device
// memory once); thread j owns row j and keeps r[j], u[j] and the row's
// bounds in registers.  Each row update is: the owner computes du_act
// and writes it to a two-slot shared broadcast, one __syncthreads, then
// every thread adds A[j, k] * du_act to its own r[j].  The slot
// alternates with every row update, so a write never meets a read of the
// previous update still in flight.  The row stride R
// (odd) keeps those column reads free of bank conflicts.
//
// Early exit (tol > 0) is decided PER ENV: after each sweep a block-wide
// max of |du_act| over the sweep is compared with
// tol * max(max_j hi_j, 1) of that env.  The TPU kernel decides per
// 128-env block (one hard env keeps its whole block sweeping), and the
// JAX CPU path never exits early; tol = 0 runs exactly `iters` sweeps.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Max of v over the block; every thread gets the result.
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < nwarps; ++w) m = fmaxf(m, red[w]);
  return m;
}

__global__ void noslip_kernel(const float* __restrict__ A_g,
                              const float* __restrict__ a_safe_g,
                              const float* __restrict__ lo_g,
                              const float* __restrict__ hi_g,
                              const float* __restrict__ gate_g,
                              const float* __restrict__ r0_g,
                              const float* __restrict__ u0_g,
                              float* __restrict__ u_out,
                              int* __restrict__ sweeps_out, int R, int iters,
                              float tol) {
  extern __shared__ float smem[];
  float* A = smem;              // R * R
  float* bcast = A + R * R;     // 2 slots
  float* red = bcast + 2;       // one per warp
  const int j = threadIdx.x;
  const bool own = j < R;
  const size_t offA = (size_t)blockIdx.x * R * R;
  const size_t offV = (size_t)blockIdx.x * R;

  for (int e = j; e < R * R; e += blockDim.x) A[e] = A_g[offA + e];
  float r = 0.0f, u = 0.0f, a_safe = 1.0f, lo = 0.0f, hi = 0.0f, gate = 0.0f;
  if (own) {
    r = r0_g[offV + j];
    u = u0_g[offV + j];
    a_safe = a_safe_g[offV + j];
    lo = lo_g[offV + j];
    hi = hi_g[offV + j];
    gate = gate_g[offV + j];
  }
  float thresh = 0.0f;
  if (tol > 0.0f)
    thresh = tol * fmaxf(block_max(own ? hi : -CUDART_INF_F, red), 1.0f);
  __syncthreads();

  int t = 0;  // row updates so far: alternates the broadcast slot
  int sweeps = iters;
  for (int s = 0; s < iters; ++s) {
    float mx = 0.0f;
    for (int k = 0; k < R; ++k, ++t) {
      float* slot = bcast + (t & 1);
      if (j == k) {
        const float du = -r / a_safe;
        const float u_new = fminf(fmaxf(u + du, lo), hi);
        const float du_act = gate > 0.0f ? u_new - u : 0.0f;
        u += du_act;
        mx = fmaxf(mx, fabsf(du_act));
        *slot = du_act;
      }
      __syncthreads();
      if (own) r += A[j * R + k] * *slot;
    }
    if (tol > 0.0f && !(block_max(mx, red) > thresh)) {
      sweeps = s + 1;
      break;
    }
  }
  if (own) u_out[offV + j] = u;
  if (sweeps_out != nullptr && j == 0) sweeps_out[blockIdx.x] = sweeps;
}

}  // namespace

// `sweeps` (B ints, may be null) receives the sweeps each env ran.
// Returns cudaErrorInvalidValue when R needs more than 1024 threads.
extern "C" int noslip_sweep(const float* A, const float* a_safe,
                            const float* lo, const float* hi,
                            const float* gate, const float* r0,
                            const float* u0, float* u, int* sweeps, int B,
                            int R, int iters, float tol, void* stream) {
  const int threads = ((R + 31) / 32) * 32;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(R * R + 2 + threads / 32) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)noslip_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (B > 0)
    noslip_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        A, a_safe, lo, hi, gate, r0, u0, u, sweeps, R, iters, tol);
  return (int)cudaGetLastError();
}
