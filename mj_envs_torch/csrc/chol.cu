// Batched Cholesky factor and substitution for small SPD matrices
// (the mass matrix M, nv = 33 on hammer-v0, and the Newton Hessian).
//
// Replaces four TPU kernels of mj_envs_tpu/physics/kernels.py:
//   chol_factor        <- _chol_factor_kernel        (chol_factor_bm)
//   chol_solve_fac     <- _chol_solve_mat_fac_kernel (_chol_solve_mat_fac_pallas)
//   chol_factor_solve  <- _chol_solve_kernel         (_chol_solve_pallas)
//   chol_solve_mat     <- _chol_solve_mat_kernel     (_chol_solve_mat_pallas)
// and keeps chol_solve_mat_block, the block reference the others equal.
//
// Layouts (row-major, batch-first): H (B, nv, nv); fac (B, nv, nv) with
// fac[b, k, :] = column k of L (zero above the diagonal entry k), the
// layout the JAX package keeps on every backend; G, X (B, nv, R).
//
// Bound on the card: memory.  Per env the factor is nv^3/3 ~ 12k flops
// on a 4.4 KB matrix, the R = 129 substitution 2 nv^2 R ~ 281k flops on
// 21 KB; at B = 512 both bounds are a few microseconds of HBM traffic
// and far below the 67 TFLOP/s float32 peak.  The real limit is the
// dependency chain of nv pivot steps, and how many threads share it.
//
// The block factor-and-solve, chol_solve_mat_block (no TPU kernel of
// its own: the arithmetic K8 had before its redesign), is the reference
// that chol_factor_solve, chol_factor then chol_solve_fac, and
// chol_solve_mat equal bit for bit (tests/test_torch_cuda.py,
// chip_smoke.py phase 3); no front end calls it.  One block per env; the
// matrix lives in shared memory for the whole factorization; the factor
// is right-looking, as on the TPU: pivot inv_s = rsqrt(akk), column k =
// row k * inv_s (the working matrix stays symmetric), then a rank-1
// trailing update spread over all threads.  A non-positive pivot yields
// NaN/inf, never a clamp or a trap: the Newton solver relies on that NaN
// to take its gradient fallback, and every kernel here keeps it.  Its
// substitution runs column-oriented (forward, then back) with threads
// over (row, right-hand side) pairs, two block barriers a step.  No TPU
// padding or batch-minor layout is carried over.
//
// chol_solve_mat (K8: noslip's X = M^-1 D^T when no factor of M is at
// hand, R = 129 on hammer) is chol_factor's warp factor, then
// chol_solve_fac's substitution, in one launch, the factor never
// leaving shared memory.  One block per env with a thread per
// right-hand side (160 threads at R = 129; beyond 256 right-hand sides a
// grid.y of blocks, each of which factors H again: nv^3/3 operations
// and one triangle of H more per 256 right-hand sides).  Warp 0 copies
// H's upper triangle by cp.async into its column store and factors it
// while every thread's loads of its right-hand side are in flight; one
// barrier, a shared-to-shared copy of the factor into the substitution's
// padded row and column layouts, a second barrier, then the
// substitution, each thread on its own column in registers.  Its result
// is chol_factor then chol_solve_fac's, and so the block reference's,
// bit for bit.  What bounds it is the factor's chain (as chol_factor's)
// followed by the substitution's instruction issue (as chol_solve_fac's
// at R = 129); the overlap hides G's trip from memory only.  R = 1 is
// exactly chol_factor_solve's problem (one right-hand side, the same
// factor and substitution order) and runs its kernel.  nv above 64
// returns cudaErrorInvalidValue.
//
// chol_factor (the mass matrix's factor, once a substep) runs the warp
// factor of chol_factor_solve (below: one warp per env, the same
// __device__ functions) and writes the factor out row by row, lane j
// writing fac[k][j], coalesced; it reads only H's upper triangle.  Its
// factor is the block factor's bit for bit.  What bounds it is K4's
// factor chain, nv steps of shared-memory reads, FMA chain, shuffle,
// rsqrt and warp sync.  Writing each row inside the factor's loop ran
// slower (the stores lengthen every step), and copying H in by 16-byte
// words into a staging area, then into the columns, no faster.  nv above
// 64 returns cudaErrorInvalidValue.
//
// chol_solve_fac (the substitution from a stored factor: noslip's
// X = M^-1 D^T at R = 129, qacc_smooth at R = 1) has no block barrier in
// its steps.  The R right-hand sides are independent problems, so from
// R = 2 up each gets a thread, its nv values in registers: one block per
// env and up to 256 right-hand sides (5 warps at R = 129, 2,560 warps at
// B = 512), the factor read once into shared memory behind the block's
// one barrier, then read by every thread at the same address (a
// broadcast, 16 bytes at a time).  G and X move coalesced over r.  A
// flat (env, column) grid would fill the ragged last warp (129 = 4 x 32
// + 1) but split a warp's factor reads over two envs and lose the
// broadcast; one block per env was chosen.  The register array is
// indexed by loops unrolled over a bucket NV (36: nv <= 36; 64: nv <= 64),
// nv placed at its end.  What bounds it: at R = 129 and B = 512 every
// block is resident at once, so a phase of moving G and X (near the
// byte bound) is followed by one of issuing ~nv^2 FMAs and 2 nv IEEE
// divides a thread with ~5 warps per SM sub-partition; the two hardly
// overlap.  Two right-hand sides a thread (half the warps) ran slower;
// 4-byte factor reads in place of 16-byte ones ran the same.  R = 1 gets
// a warp per env instead (a thread per column would leave one thread per
// env): chol_factor_solve's substitution on the stored factor, y and x
// in registers, y_k by shuffle, bound by its chain of 2 nv dependent
// steps and the factor's one trip from memory.  Both keep
// chol_subst_smem's order of operations (forward: y_k /= L_kk, then
// y_j -= L_jk y_k for j > k, k ascending; back: x_k /= L_kk, then y_i -=
// L_ik x_k for i < k, k descending) and its IEEE divides, so each element
// sees chol_solve_mat_block's roundings.  nv above 64 returns
// cudaErrorInvalidValue.
//
// chol_factor_solve (one right-hand side, the most launched kernel) runs
// one warp per env, kSolveWarps envs per block, with no block barrier.
// Lane l owns columns l and l + 32 of the matrix (nv <= 64), kept in
// shared memory column by column, each contiguous, so that a lane reads
// four rows of a column in one 16-byte load.  The factor is
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
//
// nvcc -Xptxas -v (CUDA 12.8, sm_90a):
//   chol_subst_cols_kernel<64>  98 registers, 32768 bytes smem
//   chol_subst_cols_kernel<36>  64 registers, 10368 bytes smem
//   chol_subst_warp_kernel      32 registers
//   chol_factor_solve_kernel    47 registers
//   chol_factor_kernel          37 registers
//   chol_solve_mat_kernel<64>   122 registers
//   chol_solve_mat_kernel<36>   74 registers
//   chol_solve_mat_block_kernel 30 registers
//   each: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSolveWarps = 4;   // envs per block of the warp kernels
constexpr int kMaxSolveNv = 64;  // two columns per lane
constexpr int kMaxSubstNv = 64;  // chol_solve_fac's largest nv bucket
constexpr int kSubstWarpMaxR = 1;       // up to here a warp per env
constexpr int kSubstColThreads = 256;   // right-hand sides per block
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

// Value v of the lane that owns column (or row) k: v0 for k < 32, v1
// above; every lane of the warp calls it.
__device__ __forceinline__ float from_owner(float v0, float v1, int k) {
  return __shfl_sync(kFull, k < 32 ? v0 : v1, k & 31);
}

__device__ __forceinline__ float part(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// The substitution of a thread's right-hand side y (NV values in
// registers, NV a multiple of 4 that bounds nv) on an env's factor in
// shared memory, twice: by rows of L^T (Lr[k][j] = Lt[k][j], the forward
// pass's row k) and by columns (Lc[k][i] = Lt[i][k], the back pass's),
// both padded to NV x NV at the FRONT: real index p = NV - nv + k, padded
// entries 0 with 1 on the diagonal, and y's padded values 0.  Padded
// steps are skipped, and a padded y only receives updates (in the back
// pass), never gives one, so that the real entries see exactly the
// operations of chol_subst_smem in its order, NaN and inf included.
template <int NV>
__device__ __forceinline__ void subst_cols(const float4* Lr4,
                                           const float4* Lc4, float (&y)[NV],
                                           int pad) {
  const float* Lr = reinterpret_cast<const float*>(Lr4);
  // Forward, L y = g: y_k /= L_kk, then y_j -= Lt[k][j] y_k for j > k.
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (k < pad) continue;   // block-uniform
    y[k] = y[k] / Lr[k * NV + k];
#pragma unroll
    for (int c = (k + 1) / 4; c < NV / 4; ++c) {
      const float4 l = Lr4[k * (NV / 4) + c];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * c + u > k) y[4 * c + u] -= part(l, u) * y[k];
    }
  }
  // Back, L^T x = y: x_k = y_k / L_kk, then y_i -= Lt[i][k] x_k, i < k.
#pragma unroll
  for (int k = NV - 1; k >= 0; --k) {
    if (k < pad) break;      // block-uniform
    y[k] = y[k] / Lr[k * NV + k];
#pragma unroll
    for (int c = 0; 4 * c < k; ++c) {
      const float4 l = Lc4[k * (NV / 4) + c];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * c + u < k) y[4 * c + u] -= part(l, u) * y[k];
    }
  }
}

// Thread r's right-hand side, column r of g (nv x R, row-major), into
// y[NV] at the end (subst_cols' padding); 0 where r is not live.
template <int NV>
__device__ __forceinline__ void load_rhs(const float* g, float (&y)[NV],
                                         int pad, int R, bool live) {
#pragma unroll
  for (int p = 0; p < NV; ++p)
    y[p] = (live && p >= pad) ? g[(size_t)(p - pad) * R] : 0.0f;
}

template <int NV>
__device__ __forceinline__ void store_rhs(float* x, const float (&y)[NV],
                                          int pad, int R) {
#pragma unroll
  for (int p = 0; p < NV; ++p)
    if (p >= pad) x[(size_t)(p - pad) * R] = y[p];
}

// chol_solve_fac, R >= kSubstWarpMaxR + 1: a thread per right-hand side
// (subst_cols), the env's factor read into Lr and Lc behind the block's
// one barrier.
template <int NV>
__global__ void __launch_bounds__(kSubstColThreads)
chol_subst_cols_kernel(const float* __restrict__ fac,
                       const float* __restrict__ G,
                       float* __restrict__ X, int nv, int R) {
  __shared__ float4 Lr4[NV * NV / 4], Lc4[NV * NV / 4];
  float* Lr = reinterpret_cast<float*>(Lr4);
  float* Lc = reinterpret_cast<float*>(Lc4);
  const int env = blockIdx.x;
  const int r = blockIdx.y * kSubstColThreads + threadIdx.x;
  const bool live = r < R;
  const int pad = NV - nv;
  const float* f = fac + (size_t)env * nv * nv;

  // This column's loads first, all in flight while the factor arrives.
  float y[NV];
  load_rhs<NV>(G + (size_t)env * nv * R + r, y, pad, R, live);
  for (int e = threadIdx.x; e < NV * NV; e += blockDim.x) {
    const int a = e / NV, b = e % NV;
    // Lr[a][b] = Lt[a][b] (coalesced read); Lc[a][b] = Lt[b][a].
    Lr[e] = (a >= pad && b >= pad) ? f[(a - pad) * nv + (b - pad)]
                                   : (a == b ? 1.0f : 0.0f);
    Lc[e] = (a >= pad && b >= pad) ? f[(b - pad) * nv + (a - pad)]
                                   : (a == b ? 1.0f : 0.0f);
  }
  __syncthreads();   // the only barrier
  if (!live) return;
  subst_cols<NV>(Lr4, Lc4, y, pad);
  store_rhs<NV>(X + (size_t)env * nv * R + r, y, pad, R);
}

// chol_solve_fac, R <= kSubstWarpMaxR (qacc_smooth's one right-hand
// side): a warp per env, kSolveWarps envs per block, the substitution of
// chol_factor_solve on the stored factor.  Lane l holds y_l and y_{l+32}
// (nv <= 64).  The env's factor, nv^2 floats, arrives in shared memory
// as the 16-byte-aligned span that holds it, by 16-byte cp.async (up to
// 3 floats of the neighbours on either side come along; they lie in the
// same 16-byte words as the factor's own): a few copies a lane in one
// memory latency.  Rows keep stride nv, so the forward pass's row reads
// (lane j: Lt[k][j]) are conflict-free and the back pass's column reads
// (lane i: Lt[i][k]) are too at odd nv.  The pivot step's y_k reaches
// the lanes by shuffle.
__host__ __device__ inline int subst_span4(int nv) {   // float4s a warp
  return (nv * nv + 6) / 4;
}

__global__ void __launch_bounds__(kSolveWarps * 32)
chol_subst_warp_kernel(const float* __restrict__ fac,
                       const float* __restrict__ g,
                       float* __restrict__ x, int B, int nv) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int env = blockIdx.x * kSolveWarps + (threadIdx.x >> 5);
  if (env >= B) return;   // warp-uniform
  const size_t f = reinterpret_cast<size_t>(fac + (size_t)env * nv * nv);
  const int shift = (int)(f & 15) / 4;   // floats before the factor
  const float4* src = reinterpret_cast<const float4*>(f - (f & 15));
  float4* dst = smem4 + (threadIdx.x >> 5) * subst_span4(nv);
  for (int c = lane; c < (shift + nv * nv + 3) / 4; c += 32)
    __pipeline_memcpy_async(dst + c, src + c, 16);
  __pipeline_commit();
  const float* Ls = reinterpret_cast<const float*>(dst) + shift;
  const int j0 = lane, j1 = lane + 32;   // this lane's rows
  const bool own0 = j0 < nv, own1 = j1 < nv;
  float y0 = own0 ? g[(size_t)env * nv + j0] : 0.0f;
  float y1 = own1 ? g[(size_t)env * nv + j1] : 0.0f;
  __pipeline_wait_prior(0);
  __syncwarp();

  // Forward, L y = g: y_k /= L_kk, then y_j -= Lt[k][j] y_k (j > k).
#pragma unroll 4
  for (int k = 0; k < nv; ++k) {
    const float yk = from_owner(y0, y1, k) / Ls[k * nv + k];
    if (lane == (k & 31)) {
      if (k < 32) y0 = yk;
      else y1 = yk;
    }
    if (own0 && j0 > k) y0 -= Ls[k * nv + j0] * yk;
    if (own1 && j1 > k) y1 -= Ls[k * nv + j1] * yk;
  }
  // Back, L^T x = y: x_k = y_k / L_kk, then y_i -= Lt[i][k] x_k (i < k).
#pragma unroll 4
  for (int k = nv - 1; k >= 0; --k) {
    const float xk = from_owner(y0, y1, k) / Ls[k * nv + k];
    if (lane == (k & 31)) {
      if (k < 32) y0 = xk;
      else y1 = xk;
    }
    if (j0 < k) y0 -= Ls[j0 * nv + k] * xk;
    if (j1 < k) y1 -= Ls[j1 * nv + k] * xk;
  }
  if (own0) x[(size_t)env * nv + j0] = y0;
  if (own1) x[(size_t)env * nv + j1] = y1;
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

// One env's matrix in a warp's shared memory by columns, At[j * ld + i]
// = A[i][j] (lane j's storage), for the warp factor of chol_factor and
// chol_factor_solve.  Lane l owns columns j0 = l and j1 = l + 32.
struct WarpCols {
  float* At;
  float* col0;
  float* col1;
  int ld, j0, j1;
  bool own0, own1;
  __device__ WarpCols(float* base, int nv, int lane)
      : ld(solve_ld(nv)), j0(lane), j1(lane + 32), own0(lane < nv),
        own1(lane + 32 < nv) {
    At = base + (threadIdx.x >> 5) * nv * ld;
    col0 = At + (own0 ? j0 : 0) * ld;
    col1 = At + (own1 ? j1 : 0) * ld;
  }
};

// Each lane copies the upper part of its columns of h (nv x nv, row-
// major), all copies in flight at once (one memory latency, not one per
// row); the caller waits with __pipeline_wait_prior.
__device__ __forceinline__ void copy_upper(const WarpCols& w, const float* h,
                                           int nv) {
  for (int r = 0; r < nv; ++r) {
    if (w.own0 && w.j0 >= r)
      __pipeline_memcpy_async(w.col0 + r, h + r * nv + w.j0, 4);
    if (w.own1 && w.j1 >= r)
      __pipeline_memcpy_async(w.col1 + r, h + r * nv + w.j1, 4);
  }
  __pipeline_commit();
}

// Factor, left-looking: step k finishes column k of L^T at once.  Lane j
// (j >= k) takes A[k][j] less the products of the earlier steps, in the
// order the right-looking factor subtracts them (the same roundings);
// the pivot reaches every lane from its owner by shuffle and each takes
// its rsqrt; c_j = that * inv_s becomes Lt[k][j], kept in col_j[k].
// Entries col_j[k] for k > j are never written.
__device__ __forceinline__ void warp_factor(const WarpCols& w, int nv) {
  const bool wide = nv > 32;   // the second columns are in use
  for (int k = 0; k < nv; ++k) {
    float s0, s1;
    left_update(w.col0, w.col1, w.At + k * w.ld, k, wide, s0, s1);
    const float inv_s = rsqrtf(from_owner(s0, s1, k));
    if (w.own0 && w.j0 >= k) w.col0[k] = s0 * inv_s;
    if (w.own1 && w.j1 >= k) w.col1[k] = s1 * inv_s;
    __syncwarp();   // the next step reads row k + 1, written by its owner
  }
}

// chol_factor: the warp factor written out as fac[k][j] = Lt[k][j] for
// j >= k and 0 below, row by row (lane j writes fac[k][j]: coalesced),
// four rows of a column read at a time.
__global__ void __launch_bounds__(kSolveWarps * 32)
chol_factor_kernel(const float* __restrict__ H, float* __restrict__ fac,
                   int B, int nv) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int env = blockIdx.x * kSolveWarps + (threadIdx.x >> 5);
  if (env >= B) return;
  const WarpCols w(reinterpret_cast<float*>(smem4), nv, lane);
  copy_upper(w, H + (size_t)env * nv * nv, nv);
  __pipeline_wait_prior(0);
  warp_factor(w, nv);
  float* f = fac + (size_t)env * nv * nv;
  for (int k0 = 0; k0 < nv; k0 += 4) {
    const float4 l0 = *reinterpret_cast<const float4*>(w.col0 + k0);
    const float4 l1 = *reinterpret_cast<const float4*>(w.col1 + k0);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u;
      if (k >= nv) break;
      if (w.own0) f[k * nv + w.j0] = w.j0 >= k ? part(l0, u) : 0.0f;
      if (w.own1) f[k * nv + w.j1] = w.j1 >= k ? part(l1, u) : 0.0f;
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
  const WarpCols w(reinterpret_cast<float*>(smem4), nv, lane);
  const float* At = w.At;
  const float *col0 = w.col0, *col1 = w.col1;
  const int ld = w.ld, j0 = w.j0, j1 = w.j1;
  const bool own0 = w.own0, own1 = w.own1;
  copy_upper(w, H + (size_t)env * nv * nv, nv);
  float y0 = own0 ? g[(size_t)env * nv + j0] : 0.0f;
  float y1 = own1 ? g[(size_t)env * nv + j1] : 0.0f;
  __pipeline_wait_prior(0);
  warp_factor(w, nv);

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

// chol_solve_mat, R >= 2: warp 0 factors H into a WarpCols column
// store (chol_factor's warp factor) while every thread's right-hand side
// arrives in its registers; behind one barrier the block copies the
// factor into Lr and Lc (col_j[k] = Lt[k][j], a shared-to-shared pass),
// and behind a second each thread runs subst_cols, as
// chol_subst_cols_kernel does on a stored factor.  Dynamic shared memory:
// Lr, Lc (NV x NV each), then the column store (nv x solve_ld(nv)).
template <int NV>
__global__ void __launch_bounds__(kSubstColThreads)
chol_solve_mat_kernel(const float* __restrict__ H,
                      const float* __restrict__ G, float* __restrict__ X,
                      int nv, int R) {
  extern __shared__ float4 smem4[];
  float4* Lr4 = smem4;
  float4* Lc4 = smem4 + NV * NV / 4;
  float* Lr = reinterpret_cast<float*>(Lr4);
  float* Lc = reinterpret_cast<float*>(Lc4);
  float* cols = reinterpret_cast<float*>(Lc4 + NV * NV / 4);
  const int env = blockIdx.x;
  const int r = blockIdx.y * kSubstColThreads + threadIdx.x;
  const bool live = r < R;
  const int pad = NV - nv;
  const bool factor_warp = threadIdx.x < 32;   // warp-uniform
  // Only warp 0 touches its column store (WarpCols places warp w's at
  // w x nv x ld floats).
  const WarpCols w(cols, nv, threadIdx.x & 31);
  if (factor_warp) copy_upper(w, H + (size_t)env * nv * nv, nv);
  float y[NV];
  load_rhs<NV>(G + (size_t)env * nv * R + r, y, pad, R, live);
  if (factor_warp) {
    __pipeline_wait_prior(0);
    warp_factor(w, nv);
  }
  __syncthreads();
  const int ld = w.ld;
  for (int e = threadIdx.x; e < NV * NV; e += blockDim.x) {
    const int a = e / NV, b = e % NV;
    const int i = a - pad, j = b - pad;
    // Lr[a][b] = Lt[i][j] = col_j[i] (j >= i); Lc[a][b] = Lt[j][i] =
    // col_i[j] (i >= j); the entries below the diagonal are 0, as in
    // chol_factor's factor, and col_j[k] for k > j is never written.
    const bool real = a >= pad && b >= pad;
    const float diag = a == b ? 1.0f : 0.0f;
    Lr[e] = real ? (j >= i ? cols[j * ld + i] : 0.0f) : diag;
    Lc[e] = real ? (i >= j ? cols[i * ld + j] : 0.0f) : diag;
  }
  __syncthreads();
  if (!live) return;
  subst_cols<NV>(Lr4, Lc4, y, pad);
  store_rhs<NV>(X + (size_t)env * nv * R + r, y, pad, R);
}

// chol_solve_mat_block: the block factor and substitution (one block of
// kThreads per env, everything staged in shared memory), the reference
// that chol_factor_solve, chol_factor then chol_solve_fac, and
// chol_solve_mat equal bit for bit.
__global__ void chol_solve_mat_block_kernel(const float* __restrict__ H,
                                            const float* __restrict__ G,
                                            float* __restrict__ X, int nv,
                                            int R) {
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

// Returns cudaErrorInvalidValue for nv outside 1 .. kMaxSolveNv.
extern "C" int chol_factor(const float* H, float* fac, int B, int nv,
                           void* stream) {
  if (nv < 1 || nv > kMaxSolveNv) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kSolveWarps * nv * solve_ld(nv) * sizeof(float);
  int err = set_smem((const void*)chol_factor_kernel, smem);
  if (err) return err;
  const int blocks = (B + kSolveWarps - 1) / kSolveWarps;
  if (blocks > 0)
    chol_factor_kernel<<<blocks, kSolveWarps * 32, smem,
                         (cudaStream_t)stream>>>(H, fac, B, nv);
  return (int)cudaGetLastError();
}

// Returns cudaErrorInvalidValue for nv outside 1 .. kMaxSubstNv.
extern "C" int chol_solve_fac(const float* fac, const float* G, float* X,
                              int B, int nv, int R, void* stream) {
  if (nv < 1 || nv > kMaxSubstNv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || R < 1) return (int)cudaGetLastError();
  if (R <= kSubstWarpMaxR) {
    const size_t smem = (size_t)kSolveWarps * subst_span4(nv) * sizeof(float4);
    int err = set_smem((const void*)chol_subst_warp_kernel, smem);
    if (err) return err;
    chol_subst_warp_kernel<<<(B + kSolveWarps - 1) / kSolveWarps,
                             kSolveWarps * 32, smem, s>>>(fac, G, X, B, nv);
    return (int)cudaGetLastError();
  }
  const dim3 grid(B, (R + kSubstColThreads - 1) / kSubstColThreads);
  const int threads = R < kSubstColThreads ? 32 * ((R + 31) / 32)
                                           : kSubstColThreads;
  if (nv <= 36)
    chol_subst_cols_kernel<36><<<grid, threads, 0, s>>>(fac, G, X, nv, R);
  else
    chol_subst_cols_kernel<64><<<grid, threads, 0, s>>>(fac, G, X, nv, R);
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

// Returns cudaErrorInvalidValue for nv outside 1 .. kMaxSolveNv.  R = 1
// is chol_factor_solve's problem and runs its kernel.
extern "C" int chol_solve_mat(const float* H, const float* G, float* X,
                              int B, int nv, int R, void* stream) {
  if (nv < 1 || nv > kMaxSolveNv) return (int)cudaErrorInvalidValue;
  if (R == 1) return chol_factor_solve(H, G, X, B, nv, stream);
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || R < 1) return (int)cudaGetLastError();
  const dim3 grid(B, (R + kSubstColThreads - 1) / kSubstColThreads);
  const int threads = R < kSubstColThreads ? 32 * ((R + 31) / 32)
                                           : kSubstColThreads;
  const int NV = nv <= 36 ? 36 : 64;
  const size_t smem =
      (size_t)(2 * NV * NV + nv * solve_ld(nv)) * sizeof(float);
  const void* fn = NV == 36 ? (const void*)chol_solve_mat_kernel<36>
                            : (const void*)chol_solve_mat_kernel<64>;
  int err = set_smem(fn, smem);
  if (err) return err;
  if (NV == 36)
    chol_solve_mat_kernel<36><<<grid, threads, smem, s>>>(H, G, X, nv, R);
  else
    chol_solve_mat_kernel<64><<<grid, threads, smem, s>>>(H, G, X, nv, R);
  return (int)cudaGetLastError();
}

extern "C" int chol_solve_mat_block(const float* H, const float* G, float* X,
                                    int B, int nv, int R, void* stream) {
  const size_t smem = (size_t)(2 * nv * nv + nv + nv * R) * sizeof(float);
  int err = set_smem((const void*)chol_solve_mat_block_kernel, smem);
  if (err) return err;
  if (B > 0)
    chol_solve_mat_block_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        H, G, X, nv, R);
  return (int)cudaGetLastError();
}
