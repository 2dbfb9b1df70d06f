// Noslip post-pass: projected Gauss-Seidel in residual form over the
// friction rows of one env (R = 33 dof-friction rows + 3 * 32 contact
// pairs = 129 on hammer-v0).
//
// Replaces mj_envs_tpu/physics/kernels.py:_noslip_kernel (_noslip_pallas).
// Update order is that of _noslip_scan: for each sweep, for k = 0..R-1,
//   du = -r[k] / a_safe[k];  u_new = clip(u[k] + du, lo[k], hi[k]);
//   du_act = gate[k] > 0 ? u_new - u[k] : 0;
//   r[:] += A[:, k] * du_act (one FMA a row);  u[k] += du_act.
//
// Bound on the card: memory by the roofline count (A is R*R floats,
// 66.6 KB per env, 34 MB at B = 512, read once), but the real limit is
// the dependency chain of R strictly sequential row updates a sweep: the
// owner's FMA, divide, clamp and a shuffle to the other rows, with one
// warp per SM sub-partition at B = 512 and nothing else to hide it.
//
// nvcc -Xptxas -v (CUDA 12.8, sm_90a): noslip_warp_kernel<5> 96
// registers, <8> 122; no stack, no spills.
//
// Design: one warp per env, no block barrier.  Lane l owns rows l,
// l + 32, ... (S slots, a compile-time bucket: 5 for R <= 160, 8 for
// R <= 256), their r, u, a_safe, lo, hi and gate in registers; the slot
// whose rows step now sits at index 0, and the slots rotate by one when
// its 32 steps are done, so that every register index is known at
// compile time.  At step k every lane evaluates the update of its
// index-0 row, and the owner's, lane k % 32, reaches the warp by
// __shfl_sync; each lane then adds A[j, k] * du_act to its rows' r, the
// A[j, k] loaded before the owner's chain so that the loads overlap it.
// A is never staged whole: rows j need A[j, k0 .. k0 + 15], so A streams
// through a ring of kStages chunks of 16 columns per warp in shared
// memory.  Row j's 16 columns start `shift` floats into a 16-byte word
// (the row stride R * 4 bytes is not 16-byte aligned at R = 129), so the
// chunk's row is copied as the 5 words that hold it, by 16-byte
// cp.async, and read at stage[j * 20 + shift + c] (up to 4-way bank
// conflicts).  The chunk two ahead is copied a sixteenth at each step of
// the chunk in use, so that its loads overlap the chain; the 16 steps of
// a chunk are unrolled; __pipeline_wait_prior and __syncwarp at each
// chunk's start are the only waits.  Sweeps after the first read A
// again, from L2 (34 MB at B = 512 fits the 50 MB L2).  Variants timed
// and dropped (NVIDIA H100, B = 512, R = 129, 20 sweeps): 4-byte cp.async
// of each column, 1.04 ms against 0.65 with 16-byte words; the loads of
// A[j, k] after the chain, 0.65 ms against 0.38; each copy's row and
// word worked out from its index in the chunk, 0.38 ms against 0.30;
// the copies after the step instead of before it, 0.30 either way.
//
// The divide: where the row cannot move (gate <= 0) the quotient is
// discarded, and where r is +-0 over a positive a_safe it is exactly -r;
// both, and every lane but the owner, divide 1 by 1 instead.  The
// selected operands go to div.rn.f32 by inline PTX: from a plain `/` the
// compiler divides every lane's own -r / a_safe and selects afterwards,
// and a zero dividend takes the IEEE divide's slow path (a real chunk's
// empty contact rows: 1.26 ms against 1.04 in the 4-byte variant).  The
// results are those of the one-block-per-env kernel of earlier versions
// bit for bit: the same operations on every row in the same order,
// gate-0 steps included (A * 0 still reaches r, NaN included).
//
// Early exit (tol > 0) is decided PER ENV: after each sweep the largest
// |du_act| of the sweep (every lane holds it: it is the max over the
// broadcast values) is compared with tol * max(max_j hi_j, 1) of that
// env.  The TPU kernel decides per 128-env block (one hard env keeps its
// whole block sweeping), and the JAX CPU path never exits early; tol = 0
// runs exactly `iters` sweeps.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kChunk = 16;          // columns of A per chunk
constexpr int kWords = kChunk / 4 + 1;  // 16-byte words a row of a chunk
constexpr int kLd = 4 * kWords;     // a chunk's row stride in shared memory
constexpr int kStages = 3;          // the chunk in use and two ahead
constexpr int kMaxR = 256;          // the largest slot bucket: 8 x 32 rows
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Envs a block (a warp each) and copies a lane and step for a bucket of
// S rows a lane: 4 warps below 5 rows (123 KB of ring at R = 129), 2 up
// to 8 (123 KB at R = 256).
template <int S>
struct Cfg {
  static constexpr int kWarps = S <= 5 ? 4 : 2;
  static constexpr int kCopies = (2 * kWords * S + 31) / 32;
};

// Copy part g of 16 of the chunk at column k0 into `stage`: rows g * RP
// .. (g + 1) * RP - 1 (RP = ceil(R / 16)), kWords 16-byte words each.
// Row j's 16 columns start `shift` floats into a word of device memory
// (the row stride R * 4 bytes need not be a multiple of 16; `abase` is
// A's own offset in floats, mod 4), so the row's kWords words from there
// are copied whole, 16 bytes a cp.async, and the row's column c sits at
// stage[j * kLd + shift + c].  Item q = 32 i + lane of a part is word
// q % kWords of its row q / kWords, the same for every part, so that a
// copy costs a few instructions beside the chain.  A word past the
// chunk's last column is skipped; a copied word holds at least one of
// its columns, so it lies inside A's allocation.
template <int S>
__device__ __forceinline__ void copy_part(float* stage, const float* A,
                                          int R, int RP, int abase, int k0,
                                          int g, int lane) {
  const int w = min(kChunk, R - k0);
#pragma unroll
  for (int i = 0; i < Cfg<S>::kCopies; ++i) {
    const int q = 32 * i + lane;
    const int row = g * RP + q / kWords, word = q % kWords;
    const int off = row * R + k0;
    const int shift = (abase + off) & 3;
    if (q < kWords * RP && row < R && 4 * word < shift + w)
      __pipeline_memcpy_async(stage + row * kLd + 4 * word,
                              A + (off - shift + 4 * word), 16);
  }
}

// x[v] <- x[v + 1], x[S - 1] <- x[0]: the next slot's rows to index 0.
template <int S>
__device__ __forceinline__ void rotate(float (&x)[S]) {
  const float x0 = x[0];
#pragma unroll
  for (int v = 0; v < S - 1; ++v) x[v] = x[v + 1];
  x[S - 1] = x0;
}

template <int S>
__device__ __forceinline__ void rotate_slots(float (&r)[S], float (&u)[S],
                                             float (&a)[S], float (&lo)[S],
                                             float (&hi)[S],
                                             float (&gate)[S]) {
  rotate(r);
  rotate(u);
  rotate(a);
  rotate(lo);
  rotate(hi);
  rotate(gate);
}

// Step k of the row loop, lane kk owning row k at index 0: the owner
// updates u[k], and every lane adds A[j, k] * du_act to the r of its
// rows j.  Their A[j, k] are loaded first, so that the loads overlap the
// owner's chain instead of following it.
template <int S>
__device__ __forceinline__ void row_step(
    float (&r)[S], float (&u)[S], const float (&a)[S], const float (&lo)[S],
    const float (&hi)[S], const float (&gate)[S], const float* ring,
    const int (&row)[S], int c, int kk, int lane, float& mx) {
  float col[S];
#pragma unroll
  for (int v = 0; v < S; ++v) col[v] = ring[row[v] + c];
  const float rk = r[0];
  const bool live = gate[0] > 0.0f;
  const bool divide = lane == kk && live && !(rk == 0.0f && a[0] > 0.0f);
  // The selected operands through inline PTX (see the divide, above).
  float quo;
  asm("div.rn.f32 %0, %1, %2;" : "=f"(quo)
      : "f"(divide ? -rk : 1.0f), "f"(divide ? a[0] : 1.0f));
  const float du = divide ? quo : -rk;
  const float un = fminf(fmaxf(u[0] + du, lo[0]), hi[0]);
  const float da = __shfl_sync(kFull, live ? un - u[0] : 0.0f, kk);
  if (lane == kk) u[0] += da;
  mx = fmaxf(mx, fabsf(da));
#pragma unroll
  for (int v = 0; v < S; ++v) r[v] = fmaf(col[v], da, r[v]);
}

template <int S>
__global__ void __launch_bounds__(Cfg<S>::kWarps * 32)
noslip_warp_kernel(const float* __restrict__ A_g,
                   const float* __restrict__ a_safe_g,
                   const float* __restrict__ lo_g,
                   const float* __restrict__ hi_g,
                   const float* __restrict__ gate_g,
                   const float* __restrict__ r0_g,
                   const float* __restrict__ u0_g, float* __restrict__ u_out,
                   int* __restrict__ sweeps_out, int B, int R, int iters,
                   float tol) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int env = blockIdx.x * Cfg<S>::kWarps + (threadIdx.x >> 5);
  if (env >= B) return;   // warp-uniform
  const int tile = R * kLd;
  float* ring = smem + (threadIdx.x >> 5) * kStages * tile;
  const float* A = A_g + (size_t)env * R * R;
  const size_t offV = (size_t)env * R;
  const int nq = (R + kChunk - 1) / kChunk;   // chunks a sweep
  const int ns = (R + 31) / 32;               // slots in use
  const int RP = (R + kChunk - 1) / kChunk;   // rows a copy part
  const int abase = (int)(reinterpret_cast<size_t>(A) >> 2) & 3;

  // The first two chunks in flight while the vectors arrive.
  if (iters > 0) {
    for (int p = 0; p < 2; ++p) {
      for (int g = 0; g < kChunk; ++g)
        copy_part<S>(ring + p * tile, A, R, RP, abase, (p % nq) * kChunk, g,
                     lane);
      __pipeline_commit();
    }
  }
  // Index v holds slot v's row 32v + lane; the slots rotate through
  // index 0, the owner's, as the steps pass them.
  float r[S], u[S], a[S], lo[S], hi[S], gate[S];
  float hmax = -CUDART_INF_F;
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const int j = 32 * t + lane;
    const bool own = j < R;
    r[t] = own ? r0_g[offV + j] : 0.0f;
    u[t] = own ? u0_g[offV + j] : 0.0f;
    a[t] = own ? a_safe_g[offV + j] : 1.0f;
    lo[t] = own ? lo_g[offV + j] : 0.0f;
    hi[t] = own ? hi_g[offV + j] : -CUDART_INF_F;
    gate[t] = own ? gate_g[offV + j] : 0.0f;
    hmax = fmaxf(hmax, hi[t]);
  }
  float thresh = 0.0f;
  if (tol > 0.0f) thresh = tol * fmaxf(warp_max(hmax), 1.0f);

  int sweeps = iters;
  int cur = 0;   // the ring stage of the chunk in use
  for (int s = 0; s < iters; ++s) {
    float mx = 0.0f;
    for (int q = 0; q < nq; ++q) {
      const int t = q / 2;              // the slot whose rows step now
      const int k0 = q * kChunk;
      __pipeline_wait_prior(1);         // this chunk's copies have landed
      __syncwarp();                     // and every lane is past the last one
      float* next = ring + (cur == 0 ? 2 : cur - 1) * tile;
      const int k0n = (q + 2) % nq * kChunk;
      // Where index v's row's first column sits in the ring (a row past
      // R reads row 0 and only feeds its own unused r).
      int row[S];
#pragma unroll
      for (int v = 0; v < S; ++v) {
        const int sl = t + v < S ? t + v : t + v - S;
        const int j = 32 * sl + lane;
        const int shift = (abase + j * R + k0) & 3;
        row[v] = cur * tile + (j < R ? j * kLd + shift : 0);
      }
      // Step k = k0 + c, with a sixteenth of the chunk two ahead copied
      // beside it (all of what is left after the short last chunk).
      const int kk0 = (q & 1) * kChunk;   // the owner of step k0
      if (k0 + kChunk <= R) {
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          copy_part<S>(next, A, R, RP, abase, k0n, c, lane);
          row_step(r, u, a, lo, hi, gate, ring, row, c, kk0 + c, lane, mx);
        }
      } else {
        const int w = R - k0;
        for (int c = 0; c < w; ++c) {
          copy_part<S>(next, A, R, RP, abase, k0n, c, lane);
          row_step(r, u, a, lo, hi, gate, ring, row, c, kk0 + c, lane, mx);
        }
        for (int g = w; g < kChunk; ++g)
          copy_part<S>(next, A, R, RP, abase, k0n, g, lane);
      }
      __pipeline_commit();
      cur = cur + 1 == kStages ? 0 : cur + 1;
      if ((q & 1) || q == nq - 1)   // the slot is done
        rotate_slots(r, u, a, lo, hi, gate);
    }
    for (int i = ns; i < S; ++i)    // back to slot 0
      rotate_slots(r, u, a, lo, hi, gate);
    if (tol > 0.0f && !(mx > thresh)) {
      sweeps = s + 1;
      break;
    }
  }
  __pipeline_wait_prior(0);   // no copy outlives the warp
#pragma unroll
  for (int t = 0; t < S; ++t)
    if (32 * t + lane < R) u_out[offV + 32 * t + lane] = u[t];
  if (sweeps_out != nullptr && lane == 0) sweeps_out[env] = sweeps;
}

}  // namespace

// `sweeps` (B ints, may be null) receives the sweeps each env ran.
// Returns cudaErrorInvalidValue for R outside 1 .. kMaxR.
extern "C" int noslip_sweep(const float* A, const float* a_safe,
                            const float* lo, const float* hi,
                            const float* gate, const float* r0,
                            const float* u0, float* u, int* sweeps, int B,
                            int R, int iters, float tol, void* stream) {
  if (R < 1 || R > kMaxR) return (int)cudaErrorInvalidValue;
  const bool small = R <= 5 * 32;
  const int warps = small ? Cfg<5>::kWarps : Cfg<8>::kWarps;
  const size_t smem = (size_t)warps * kStages * R * kLd * sizeof(float);
  const void* fn = small ? (const void*)noslip_warp_kernel<5>
                         : (const void*)noslip_warp_kernel<8>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + warps - 1) / warps;
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks > 0) {
    if (small)
      noslip_warp_kernel<5><<<blocks, warps * 32, smem, s>>>(
          A, a_safe, lo, hi, gate, r0, u0, u, sweeps, B, R, iters, tol);
    else
      noslip_warp_kernel<8><<<blocks, warps * 32, smem, s>>>(
          A, a_safe, lo, hi, gate, r0, u0, u, sweeps, B, R, iters, tol);
  }
  return (int)cudaGetLastError();
}
