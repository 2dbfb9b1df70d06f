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
// Design: one block per env; the matrix lives in shared memory for the
// whole factorization (each element is read from device memory once and
// each output written once).  The two factor-and-solve kernels never
// write the factor to device memory.  The factor is right-looking, as on the
// TPU: pivot inv_s = rsqrt(akk), column k = row k * inv_s (the working
// matrix stays symmetric), then a rank-1 trailing update spread over
// all threads.  A non-positive pivot yields NaN/inf, never a clamp or a
// trap: the Newton solver relies on that NaN to take its gradient
// fallback.  Substitution runs column-oriented (forward, then back) with
// threads over (row, right-hand side) pairs.  No TPU padding or
// batch-minor layout is carried over.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

__global__ void chol_factor_solve_kernel(const float* __restrict__ H,
                                         const float* __restrict__ g,
                                         float* __restrict__ x, int nv) {
  extern __shared__ float smem[];
  float* A = smem;
  float* Lt = A + nv * nv;
  float* col = Lt + nv * nv;
  float* y = col + nv;
  const size_t off = (size_t)blockIdx.x * nv * nv;
  for (int e = threadIdx.x; e < nv * nv; e += blockDim.x) A[e] = H[off + e];
  for (int e = threadIdx.x; e < nv; e += blockDim.x)
    y[e] = g[(size_t)blockIdx.x * nv + e];
  chol_factor_smem(A, Lt, col, nv);
  chol_subst_smem(Lt, y, nv, 1);
  for (int e = threadIdx.x; e < nv; e += blockDim.x)
    x[(size_t)blockIdx.x * nv + e] = y[e];
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

extern "C" int chol_factor_solve(const float* H, const float* g, float* x,
                                 int B, int nv, void* stream) {
  const size_t smem = (size_t)(2 * nv * nv + 2 * nv) * sizeof(float);
  int err = set_smem((const void*)chol_factor_solve_kernel, smem);
  if (err) return err;
  if (B > 0)
    chol_factor_solve_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        H, g, x, nv);
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
