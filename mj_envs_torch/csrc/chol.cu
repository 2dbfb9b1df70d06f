// Batched Cholesky factor and substitution for small SPD matrices
// (the mass matrix M, nv = 33 on hammer-v0, and the Newton Hessian).
//
// Replaces four TPU kernels of mj_envs_tpu/physics/kernels.py:
//   chol_factor        <- _chol_factor_kernel        (chol_factor_bm)
//   chol_solve_fac     <- _chol_solve_mat_fac_kernel (_chol_solve_mat_fac_pallas)
//   chol_factor_solve  <- _chol_solve_kernel         (_chol_solve_pallas)
//   chol_solve_mat     <- _chol_solve_mat_kernel     (_chol_solve_mat_pallas)
//
// Layouts (row-major, batch-first): H (B, nv, nv); fac (B, nv, nv) with
// fac[b, k, :] = column k of L (zero above the diagonal entry k), the
// layout the JAX package keeps on every backend; G, X (B, nv, R).
//
// Bound on the card: memory.  Per env the factor is nv^3/3 ~ 12k flops
// on a 4.4 KB matrix, the R = 129 substitution 2 nv^2 R ~ 281k flops on
// 21 KB; at B = 512 both bounds are a few microseconds of HBM traffic
// and far below the 67 TFLOP/s float32 peak.  The real limit is the
// dependency chain: nv sequential pivot steps, each a block barrier.
//
// Design of chol_factor, chol_solve_fac and chol_solve_mat: one block
// per env; the matrix lives in shared memory for the whole factorization
// (each element is read from device memory once and each output written
// once).  The factor-and-solve kernels never write the factor to device
// memory.  The factor is right-looking, as on the TPU: pivot inv_s =
// rsqrt(akk), column k = row k * inv_s (the working matrix stays
// symmetric), then a rank-1 trailing update spread over all threads.  A
// non-positive pivot yields NaN/inf, never a clamp or a trap: the Newton
// solver relies on that NaN to take its gradient fallback.  Substitution
// runs column-oriented (forward, then back) with threads over (row,
// right-hand side) pairs.  No TPU padding or batch-minor layout is
// carried over.
//
// chol_factor_solve (one right-hand side, the most launched kernel) runs
// one warp per env instead, kSolveWarps envs per block, with no block
// barrier.  Lane l owns columns l and l + 32 of the matrix (nv <= 64),
// kept in shared memory column by column, each contiguous, so that a
// lane reads four rows of a column in one 16-byte load.  The factor is
// left-looking: step k finishes column k of L^T at once, each lane
// subtracting the earlier steps' products from its own entry in the
// order the right-looking factor subtracts them, so the roundings, and
// the result, are those of the block version bit for bit.  The pivot
// reaches the lanes by shuffle (each takes rsqrt of the same value); y
// and x stay in registers.  Only the upper triangle of H is read, copied
// to shared memory asynchronously (cp.async), so that its rows arrive in
// one memory latency.  What bounds it is the chain of nv dependent steps
// (shared memory, shuffle, rsqrt, warp sync) and the 2 nv steps of the
// substitutions (shuffle, divide), with one warp per SM sub-partition
// at B = 512 and nothing to hide their latency.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSolveWarps = 4;   // envs per block of chol_factor_solve
constexpr int kMaxSolveNv = 64;  // two columns per lane
constexpr unsigned kFull = 0xffffffffu;

// Column stride of chol_factor_solve's matrix: a multiple of 4 floats
// (16-byte chunks) of at least nv, an odd number of chunks, so that the
// 8 lanes of a 16-byte access phase hit distinct banks.
__host__ __device__ inline int solve_ld(int nv) {
  return 4 * (((nv + 3) / 4) | 1);
}

// Right-looking Cholesky of the nv x nv matrix A (shared, row-major,
// overwritten).  Writes Lt[k * nv + j] = L[j][k] for j >= k, 0 for j < k.
__device__ void chol_factor_smem(float* A, float* Lt, float* col, int nv) {
  const int tid = threadIdx.x;
  for (int k = 0; k < nv; ++k) {
    __syncthreads();
    const float inv_s = rsqrtf(A[k * nv + k]);
    for (int j = tid; j < nv; j += blockDim.x) {
      const float c = (j >= k) ? A[k * nv + j] * inv_s : 0.0f;
      Lt[k * nv + j] = c;
      col[j] = (j > k) ? c : 0.0f;
    }
    __syncthreads();
    const int m = nv - k - 1;  // trailing block (k+1 .. nv-1)^2
    for (int e = tid; e < m * m; e += blockDim.x) {
      const int i = k + 1 + e / m;
      const int j = k + 1 + e % m;
      A[i * nv + j] -= col[i] * col[j];
    }
  }
  __syncthreads();
}

// Solve (L L^T) X = Y in place for R right-hand sides; Lt as above,
// Y (nv, R) row-major in shared memory.
__device__ void chol_subst_smem(const float* Lt, float* Y, int nv, int R) {
  const int tid = threadIdx.x;
  // Forward: L y = g.
  for (int k = 0; k < nv; ++k) {
    __syncthreads();
    const float lkk = Lt[k * nv + k];
    for (int r = tid; r < R; r += blockDim.x) Y[k * R + r] /= lkk;
    __syncthreads();
    const int m = nv - k - 1;
    for (int e = tid; e < m * R; e += blockDim.x) {
      const int j = k + 1 + e / R;
      const int r = e % R;
      Y[j * R + r] -= Lt[k * nv + j] * Y[k * R + r];
    }
  }
  // Back: L^T x = y.
  for (int k = nv - 1; k >= 0; --k) {
    __syncthreads();
    const float lkk = Lt[k * nv + k];
    for (int r = tid; r < R; r += blockDim.x) Y[k * R + r] /= lkk;
    __syncthreads();
    for (int e = tid; e < k * R; e += blockDim.x) {
      const int i = e / R;
      const int r = e % R;
      Y[i * R + r] -= Lt[i * nv + k] * Y[k * R + r];
    }
  }
  __syncthreads();
}

__global__ void chol_factor_kernel(const float* __restrict__ H,
                                   float* __restrict__ fac, int nv) {
  extern __shared__ float smem[];
  float* A = smem;
  float* Lt = A + nv * nv;
  float* col = Lt + nv * nv;
  const size_t off = (size_t)blockIdx.x * nv * nv;
  for (int e = threadIdx.x; e < nv * nv; e += blockDim.x) A[e] = H[off + e];
  chol_factor_smem(A, Lt, col, nv);
  for (int e = threadIdx.x; e < nv * nv; e += blockDim.x) fac[off + e] = Lt[e];
}

__global__ void chol_solve_fac_kernel(const float* __restrict__ fac,
                                      const float* __restrict__ G,
                                      float* __restrict__ X, int nv, int R) {
  extern __shared__ float smem[];
  float* Lt = smem;
  float* Y = Lt + nv * nv;
  const size_t offL = (size_t)blockIdx.x * nv * nv;
  const size_t offY = (size_t)blockIdx.x * nv * R;
  for (int e = threadIdx.x; e < nv * nv; e += blockDim.x) Lt[e] = fac[offL + e];
  for (int e = threadIdx.x; e < nv * R; e += blockDim.x) Y[e] = G[offY + e];
  chol_subst_smem(Lt, Y, nv, R);
  for (int e = threadIdx.x; e < nv * R; e += blockDim.x) X[offY + e] = Y[e];
}

// Value v of the lane that owns column (or row) k: v0 for k < 32, v1
// above; every lane of the warp calls it.
__device__ __forceinline__ float from_owner(float v0, float v1, int k) {
  return __shfl_sync(kFull, k < 32 ? v0 : v1, k & 31);
}

__device__ __forceinline__ float part(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// A[k][j] less the steps p < k of the right-looking factor, in their
// order: s = col[k] - sum_p col[p] rowk[p], col[p] = L[j][p], rowk[p] =
// L[k][p], four p at a time; for both of a lane's columns at once (the
// second only where nv > 32), so that the two chains overlap.
__device__ __forceinline__ void left_update(const float* col0,
                                            const float* col1,
                                            const float* rowk, int k,
                                            bool wide, float& s0,
                                            float& s1) {
  s0 = col0[k];
  s1 = wide ? col1[k] : 0.0f;
  for (int p0 = 0; p0 < k; p0 += 4) {
    const float4 b = *reinterpret_cast<const float4*>(rowk + p0);
    const float4 a0 = *reinterpret_cast<const float4*>(col0 + p0);
    if (wide) {
      const float4 a1 = *reinterpret_cast<const float4*>(col1 + p0);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (p0 + u < k) {
          s0 -= part(a0, u) * part(b, u);
          s1 -= part(a1, u) * part(b, u);
        }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (p0 + u < k) s0 -= part(a0, u) * part(b, u);
    }
  }
}

__global__ void __launch_bounds__(kSolveWarps * 32)
chol_factor_solve_kernel(const float* __restrict__ H,
                         const float* __restrict__ g,
                         float* __restrict__ x, int B, int nv) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int env = blockIdx.x * kSolveWarps + (threadIdx.x >> 5);
  if (env >= B) return;
  const int ld = solve_ld(nv);
  // The matrix by columns, At[j * ld + i] = A[i][j]: lane j's storage.
  float* At = reinterpret_cast<float*>(smem4)
            + (threadIdx.x >> 5) * nv * ld;
  const float* h = H + (size_t)env * nv * nv;
  const int j0 = lane, j1 = lane + 32;   // this lane's columns
  const bool own0 = j0 < nv, own1 = j1 < nv;
  float* col0 = At + (own0 ? j0 : 0) * ld;
  float* col1 = At + (own1 ? j1 : 0) * ld;
  // Each lane copies the upper part of its columns, all copies in
  // flight at once (one memory latency, not one per row).
  for (int r = 0; r < nv; ++r) {
    if (own0 && j0 >= r) __pipeline_memcpy_async(col0 + r, h + r * nv + j0, 4);
    if (own1 && j1 >= r) __pipeline_memcpy_async(col1 + r, h + r * nv + j1, 4);
  }
  __pipeline_commit();
  float y0 = own0 ? g[(size_t)env * nv + j0] : 0.0f;
  float y1 = own1 ? g[(size_t)env * nv + j1] : 0.0f;
  __pipeline_wait_prior(0);

  // Factor, left-looking: step k finishes column k of L^T at once.
  // Lane j (j >= k) takes A[k][j] less the products of the earlier steps,
  // in the order the right-looking factor subtracts them (the same
  // roundings); the pivot reaches every lane from its owner by shuffle
  // and each takes its rsqrt; c_j = that * inv_s becomes Lt[k][j].
  const bool wide = nv > 32;   // the second columns are in use
  for (int k = 0; k < nv; ++k) {
    float s0, s1;
    left_update(col0, col1, At + k * ld, k, wide, s0, s1);
    const float inv_s = rsqrtf(from_owner(s0, s1, k));
    if (own0 && j0 >= k) col0[k] = s0 * inv_s;
    if (own1 && j1 >= k) col1[k] = s1 * inv_s;
    __syncwarp();   // the next step reads row k + 1, written by its owner
  }

  // Forward, L y = g: y_k = y_k / Lt[k][k], then y_j -= Lt[k][j] y_k
  // (j > k); Lt[k][j] comes from column j, four rows at a time.  Every
  // lane divides the owner's y_k by the same pivot.
  for (int k0 = 0; k0 < nv; k0 += 4) {
    const float4 l0 = *reinterpret_cast<const float4*>(col0 + k0);
    const float4 l1 = *reinterpret_cast<const float4*>(col1 + k0);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u;
      if (k >= nv) break;
      const float yk = from_owner(y0, y1, k) / At[k * ld + k];
      if (lane == (k & 31)) {
        if (k < 32) y0 = yk;
        else y1 = yk;
      }
      if (own0 && j0 > k) y0 -= part(l0, u) * yk;
      if (own1 && j1 > k) y1 -= part(l1, u) * yk;
    }
  }
  // Back, L^T x = y: x_k = y_k / Lt[k][k], then y_i -= Lt[i][k] x_k
  // (i < k), Lt[i][k] from column k; lane l holds rows l and l + 32.
  for (int k = nv - 1; k >= 0; --k) {
    const float xk = from_owner(y0, y1, k) / At[k * ld + k];
    if (lane == (k & 31)) {
      if (k < 32) y0 = xk;
      else y1 = xk;
    }
    if (j0 < k) y0 -= At[k * ld + j0] * xk;
    if (j1 < k) y1 -= At[k * ld + j1] * xk;
  }
  if (own0) x[(size_t)env * nv + j0] = y0;
  if (own1) x[(size_t)env * nv + j1] = y1;
}

__global__ void chol_solve_mat_kernel(const float* __restrict__ H,
                                      const float* __restrict__ G,
                                      float* __restrict__ X, int nv, int R) {
  extern __shared__ float smem[];
  float* A = smem;
  float* Lt = A + nv * nv;
  float* col = Lt + nv * nv;
  float* Y = col + nv;
  const size_t off = (size_t)blockIdx.x * nv * nv;
  const size_t offY = (size_t)blockIdx.x * nv * R;
  for (int e = threadIdx.x; e < nv * nv; e += blockDim.x) A[e] = H[off + e];
  for (int e = threadIdx.x; e < nv * R; e += blockDim.x) Y[e] = G[offY + e];
  chol_factor_smem(A, Lt, col, nv);
  chol_subst_smem(Lt, Y, nv, R);
  for (int e = threadIdx.x; e < nv * R; e += blockDim.x) X[offY + e] = Y[e];
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" int chol_factor(const float* H, float* fac, int B, int nv,
                           void* stream) {
  const size_t smem = (size_t)(2 * nv * nv + nv) * sizeof(float);
  int err = set_smem((const void*)chol_factor_kernel, smem);
  if (err) return err;
  if (B > 0)
    chol_factor_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(H, fac, nv);
  return (int)cudaGetLastError();
}

extern "C" int chol_solve_fac(const float* fac, const float* G, float* X,
                              int B, int nv, int R, void* stream) {
  const size_t smem = (size_t)(nv * nv + nv * R) * sizeof(float);
  int err = set_smem((const void*)chol_solve_fac_kernel, smem);
  if (err) return err;
  if (B > 0)
    chol_solve_fac_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        fac, G, X, nv, R);
  return (int)cudaGetLastError();
}

// Returns cudaErrorInvalidValue for nv outside 1 .. kMaxSolveNv.
extern "C" int chol_factor_solve(const float* H, const float* g, float* x,
                                 int B, int nv, void* stream) {
  if (nv < 1 || nv > kMaxSolveNv) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kSolveWarps * nv * solve_ld(nv) * sizeof(float);
  int err = set_smem((const void*)chol_factor_solve_kernel, smem);
  if (err) return err;
  const int blocks = (B + kSolveWarps - 1) / kSolveWarps;
  if (blocks > 0)
    chol_factor_solve_kernel<<<blocks, kSolveWarps * 32, smem,
                               (cudaStream_t)stream>>>(H, g, x, B, nv);
  return (int)cudaGetLastError();
}

extern "C" int chol_solve_mat(const float* H, const float* G, float* X,
                              int B, int nv, int R, void* stream) {
  const size_t smem = (size_t)(2 * nv * nv + nv + nv * R) * sizeof(float);
  int err = set_smem((const void*)chol_solve_mat_kernel, smem);
  if (err) return err;
  if (B > 0)
    chol_solve_mat_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        H, G, X, nv, R);
  return (int)cudaGetLastError();
}
