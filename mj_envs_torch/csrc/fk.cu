// Fused forward kinematics: the whole FK of one env in one warp.
//
// Replaces mj_envs_tpu/physics/fk_kernel.py:_fk_kernel (fk_pallas):
// body tree walk (parent frame, body offset, the body's hinge/slide
// joints in order), xpos/xquat/xmat, xipos, geom and site poses, joint
// anchors and axes, subtree com, cdof and the 6x6 cinert about each tree
// root's subtree com.  The arithmetic is that of the plain version
// (mj_envs_torch/physics/kinematics.py kinematics_plain, maths.py): a
// hinge's quaternion is renormalised after it is composed (sqrt, divide
// by max(n, 1e-15)); its anchor is taken before the rotation and the
// position re-derived after it; sinf/cosf of q / 2.
//
// One kernel serves every task: the static tree arrives as an int32
// table (layout below) built once per model by the wrapper, and each
// model field has a batch stride, 0 where the field is shared by all
// envs and the per-env size where the env carries its own copy (the
// task's ModelVar), so shared fields are never broadcast to B copies.
// The table, qpos and the env's fields are copied to shared memory
// asynchronously (cp.async) before the walk.
//
// Bound on the card: memory.  Per env (hammer) the outputs are ~3.1k
// floats, the inputs qpos and the per-env fields, ~12.8 KB in all: at
// B = 512 about 6.6 MB, 2 us at 3.35 TB/s; the arithmetic is ~25k flops
// per env.  What costs time is the chain of dependent steps down the
// tree (8 levels on every Adroit tree, up to 6 joints per body).
//
// Design: one warp per env, kWarps envs per block (B = 512 fills 128
// blocks).  The tree is walked level by level: the bodies of one level
// go to the lanes (a level of more than 32 bodies loops), a body's
// joints stay in order inside its lane, and parent poses come from the
// env's slab of shared memory.  Everything after the walk spreads over
// the lanes: a lane per body, geom, site or joint, results staged in
// shared memory and copied out so that neighbouring lanes store
// neighbouring addresses of the env's slab of each output; cinert is
// written element by element from a 14-float record per body.  The
// subtree com needs no atomics: bodies are in depth-first order, so the
// subtree of b is the range [b, b + size_b) and lane b sums it in body
// order (the only sum whose order differs from the plain version).
// Every per-env array lives in shared memory, sized from the model at
// launch; no per-thread array is indexed at run time (`nvcc -Xptxas -v`:
// 80 registers, no spills; the 32-byte stack frame is sinf/cosf's own
// argument reduction, which runs only for |q / 2| > 105615).
//
// Table layout (int32): parent[nbody] | jnt_adr[nbody + 1] (the joints of
// body b are jnt_order[jnt_adr[b] .. jnt_adr[b + 1]]) | jnt_order[njnt] |
// jnt_type[njnt] | jnt_qposadr[njnt] | jnt_bodyid[njnt] |
// geom_bodyid[ngeom] | site_bodyid[nsite] | body_rootid[nbody] |
// subtree_size[nbody] | depth_order[nbody] (the bodies by depth, then
// id) | level_adr[nlevel + 1] (level L is depth_order[level_adr[L] ..
// level_adr[L + 1]]; level 0 is the world body).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

// No fixed body limit: what bounds a model is the shared memory of one
// block, the table and kWarps slabs (the formula in fk below), against
// the 227 KB a block may hold on sm_90 (kinematics.fk_smem_bytes).
constexpr int kWarps = 4;   // envs per block, one warp each
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kSlide = 2;
constexpr int kHinge = 3;

// Model fields, in this order, and the outputs (the Kin fields without
// root_com, which the wrapper gathers from subtree_com).
enum In { BODY_POS, BODY_QUAT, BODY_IPOS, BODY_IQUAT, JNT_POS, JNT_AXIS,
          GEOM_POS, GEOM_QUAT, SITE_POS, SITE_QUAT, BODY_MASS,
          BODY_INERTIA, N_IN };
enum Out { XPOS, XQUAT, XMAT, XIPOS, GEOM_XPOS, GEOM_XMAT, SITE_XPOS,
           SITE_XMAT, XANCHOR, XAXIS, SUBTREE_COM, CDOF, CINERT, N_OUT };

struct FkArgs {
  const float* in[N_IN];
  long long in_stride[N_IN];  // floats per env; 0 = shared
  float* out[N_OUT];
};

struct Dims {
  int nq, nbody, njnt, ngeom, nsite, nlevel, ntab;
  int warp_floats;  // shared floats per env (layout in fk_kernel)
};

// Floats each cinert record holds: inert_world[9], d[3], |d|^2, mass.
constexpr int kRec = 14;

// Floats of the model fields one env reads.
__host__ __device__ inline int in_floats(const Dims& d) {
  return 18 * d.nbody + 6 * d.njnt + 7 * d.ngeom + 7 * d.nsite;
}

__host__ __device__ inline int stage_floats(const Dims& d) {
  int n = kRec * d.nbody;
  n = n > 12 * d.ngeom ? n : 12 * d.ngeom;
  n = n > 12 * d.nsite ? n : 12 * d.nsite;
  return n > 6 * d.njnt ? n : 6 * d.njnt;
}

__device__ __forceinline__ void qmul(const float* a, const float* b,
                                     float* o) {
  const float w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  const float x = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  const float y = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  const float z = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
  o[0] = w; o[1] = x; o[2] = y; o[3] = z;
}

__device__ __forceinline__ void cross(const float* a, const float* b,
                                      float* o) {
  const float x = a[1] * b[2] - a[2] * b[1];
  const float y = a[2] * b[0] - a[0] * b[2];
  const float z = a[0] * b[1] - a[1] * b[0];
  o[0] = x; o[1] = y; o[2] = z;
}

// v + 2 (qw (qv x v) + qv x (qv x v))
__device__ __forceinline__ void qrot(const float* q, const float* v,
                                     float* o) {
  float uv[3], uuv[3];
  cross(q + 1, v, uv);
  cross(q + 1, uv, uuv);
  for (int i = 0; i < 3; ++i) o[i] = v[i] + 2.0f * (q[0] * uv[i] + uuv[i]);
}

__device__ __forceinline__ void qnorm(float* q) {
  float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  n = fmaxf(n, 1e-15f);
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
}

// Rotation matrix of a quaternion, row-major (maths.quat_to_mat).
__device__ __forceinline__ void q2m(const float* q, float* m) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  m[0] = 1.0f - 2.0f * (yy + zz); m[1] = 2.0f * (xy - wz);
  m[2] = 2.0f * (xz + wy);        m[3] = 2.0f * (xy + wz);
  m[4] = 1.0f - 2.0f * (xx + zz); m[5] = 2.0f * (yz - wx);
  m[6] = 2.0f * (xz - wy);        m[7] = 2.0f * (yz + wx);
  m[8] = 1.0f - 2.0f * (xx + yy);
}

// Pose (pos, quat) of a frame fixed on a body: pos = xpos + R local_pos,
// mat = R(xquat * local_quat).
__device__ __forceinline__ void attach(const float* xp, const float* xq,
                                       const float* lp, const float* lq,
                                       float* pos_out, float* mat_out) {
  float r[3], q[4];
  qrot(xq, lp, r);
  for (int i = 0; i < 3; ++i) pos_out[i] = xp[i] + r[i];
  qmul(xq, lq, q);
  q2m(q, mat_out);
}

// Element (i, k) of skew(d), d x v = skew(d) v.
__device__ __forceinline__ float skew(const float* d, int i, int k) {
  if (i == k) return 0.0f;
  const float v = d[3 - i - k];
  return (k - i + 3) % 3 == 1 ? -v : v;
}

// Copy n floats of the warp's shared slab to an output, lane-strided.
__device__ __forceinline__ void flush(const float* src, float* dst, int n,
                                      int lane) {
  for (int e = lane; e < n; e += 32) dst[e] = src[e];
}

__global__ void __launch_bounds__(kWarps * 32, 1)
fk_kernel(const float* __restrict__ qpos, const int* __restrict__ tab_g,
          FkArgs a, int B, Dims d) {
  extern __shared__ int tab[];
  for (int i = threadIdx.x; i < d.ntab; i += blockDim.x)
    __pipeline_memcpy_async(tab + i, tab_g + i, 4);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int env = blockIdx.x * kWarps + warp;
  if (env >= B) return;

  const int nb = d.nbody, nj = d.njnt, ng = d.ngeom, ns = d.nsite;
  const int* parent = tab;
  const int* jnt_adr = parent + nb;
  const int* jnt_order = jnt_adr + nb + 1;
  const int* jnt_type = jnt_order + nj;
  const int* jnt_qposadr = jnt_type + nj;
  const int* jnt_bodyid = jnt_qposadr + nj;
  const int* geom_bodyid = jnt_bodyid + nj;
  const int* site_bodyid = geom_bodyid + ng;
  const int* body_rootid = site_bodyid + ns;
  const int* subtree_size = body_rootid + nb;
  const int* depth_order = subtree_size + nb;
  const int* level_adr = depth_order + nb;

  // The env's slab: qpos | the model fields (In order) | xpos | xquat |
  // xipos | subtree com | xanchor | xaxis | stage (one output's staged
  // values or the cinert records).
  float* qs = reinterpret_cast<float*>(tab + d.ntab) + warp * d.warp_floats;
  float* fields = qs + d.nq;
  float* xpos = fields + in_floats(d);
  float* xquat = xpos + 3 * nb;
  float* xipos = xquat + 4 * nb;
  float* com = xipos + 3 * nb;
  float* xanc = com + 3 * nb;
  float* xax = xanc + 3 * nj;
  float* stage = xax + 3 * nj;

  // Copy qpos and the env's model fields in, every copy in flight at
  // once: one memory latency, where reading the fields as the walk needs
  // them would pay one per level.
  for (int i = lane; i < d.nq; i += 32)
    __pipeline_memcpy_async(qs + i, qpos + (size_t)env * d.nq + i, 4);
  const int in_size[N_IN] = {3 * nb, 4 * nb, 3 * nb, 4 * nb, 3 * nj, 3 * nj,
                             3 * ng, 4 * ng, 3 * ns, 4 * ns, nb, 3 * nb};
  const float* F[N_IN];
  float* dst = fields;
#pragma unroll
  for (int k = 0; k < N_IN; ++k) {
    const float* src = a.in[k] + env * a.in_stride[k];
    for (int e = lane; e < in_size[k]; e += 32)
      __pipeline_memcpy_async(dst + e, src + e, 4);
    F[k] = dst;
    dst += in_size[k];
  }
  __pipeline_commit();
  float* O[N_OUT];
  const int per_env[N_OUT] = {3 * nb, 4 * nb, 9 * nb, 3 * nb, 3 * ng,
                              9 * ng, 3 * ns, 9 * ns, 3 * nj, 3 * nj,
                              3 * nb, 6 * nj, 36 * nb};
#pragma unroll
  for (int k = 0; k < N_OUT; ++k) O[k] = a.out[k] + (size_t)env * per_env[k];
  __pipeline_wait_prior(0);

  if (lane == 0) {
    xpos[0] = xpos[1] = xpos[2] = 0.0f;
    xquat[0] = 1.0f;
    xquat[1] = xquat[2] = xquat[3] = 0.0f;
  }
  __syncwarp();

  // Tree walk, one level at a time (a level's parents are all above it).
  for (int L = 1; L < d.nlevel; ++L) {
    for (int t = level_adr[L] + lane; t < level_adr[L + 1]; t += 32) {
      const int b = depth_order[t];
      const int p = parent[b];
      float pq[4], pp[3], r[3];
      qmul(xquat + 4 * p, F[BODY_QUAT] + 4 * b, pq);
      qrot(xquat + 4 * p, F[BODY_POS] + 3 * b, r);
      for (int i = 0; i < 3; ++i) pp[i] = xpos[3 * p + i] + r[i];
      for (int u = jnt_adr[b]; u < jnt_adr[b + 1]; ++u) {
        const int j = jnt_order[u];
        const float qj = qs[jnt_qposadr[j]];
        const float* axis = F[JNT_AXIS] + 3 * j;
        const float* jp = F[JNT_POS] + 3 * j;
        if (jnt_type[j] == kSlide) {
          const float s[3] = {axis[0] * qj, axis[1] * qj, axis[2] * qj};
          qrot(pq, s, r);
          for (int i = 0; i < 3; ++i) pp[i] = pp[i] + r[i];
        } else {  // hinge about the anchor jnt_pos
          const float half = 0.5f * qj;
          const float sn = sinf(half);
          const float qr[4] = {cosf(half), sn * axis[0], sn * axis[1],
                               sn * axis[2]};
          float anchor[3], nq4[4];
          qrot(pq, jp, r);
          for (int i = 0; i < 3; ++i) anchor[i] = pp[i] + r[i];
          qmul(pq, qr, nq4);
          qnorm(nq4);
          for (int i = 0; i < 4; ++i) pq[i] = nq4[i];
          qrot(pq, jp, r);
          for (int i = 0; i < 3; ++i) pp[i] = anchor[i] - r[i];
        }
        qrot(pq, jp, r);
        for (int i = 0; i < 3; ++i) xanc[3 * j + i] = pp[i] + r[i];
        qrot(pq, axis, xax + 3 * j);
      }
      for (int i = 0; i < 3; ++i) xpos[3 * b + i] = pp[i];
      for (int i = 0; i < 4; ++i) xquat[4 * b + i] = pq[i];
    }
    __syncwarp();
  }
  flush(xpos, O[XPOS], 3 * nb, lane);
  flush(xquat, O[XQUAT], 4 * nb, lane);
  flush(xanc, O[XANCHOR], 3 * nj, lane);
  flush(xax, O[XAXIS], 3 * nj, lane);

  // Body frames and inertial frames.
  for (int b = lane; b < nb; b += 32) {
    float r[3];
    q2m(xquat + 4 * b, stage + 9 * b);
    qrot(xquat + 4 * b, F[BODY_IPOS] + 3 * b, r);
    for (int i = 0; i < 3; ++i) xipos[3 * b + i] = xpos[3 * b + i] + r[i];
  }
  __syncwarp();
  flush(stage, O[XMAT], 9 * nb, lane);
  flush(xipos, O[XIPOS], 3 * nb, lane);
  __syncwarp();

  // Geom and site poses: positions, then matrices, in the stage.
  for (int g = lane; g < ng; g += 32) {
    const int b = geom_bodyid[g];
    attach(xpos + 3 * b, xquat + 4 * b, F[GEOM_POS] + 3 * g,
           F[GEOM_QUAT] + 4 * g, stage + 3 * g, stage + 3 * ng + 9 * g);
  }
  __syncwarp();
  flush(stage, O[GEOM_XPOS], 3 * ng, lane);
  flush(stage + 3 * ng, O[GEOM_XMAT], 9 * ng, lane);
  __syncwarp();
  for (int s = lane; s < ns; s += 32) {
    const int b = site_bodyid[s];
    attach(xpos + 3 * b, xquat + 4 * b, F[SITE_POS] + 3 * s,
           F[SITE_QUAT] + 4 * s, stage + 3 * s, stage + 3 * ns + 9 * s);
  }
  __syncwarp();
  flush(stage, O[SITE_XPOS], 3 * ns, lane);
  flush(stage + 3 * ns, O[SITE_XMAT], 9 * ns, lane);

  // Subtree com: the subtree of b is the body range [b, b + size_b).
  for (int b = lane; b < nb; b += 32) {
    float m_sum = 0.0f, p[3] = {0.0f, 0.0f, 0.0f};
    for (int k = b; k < b + subtree_size[b]; ++k) {
      const float m = F[BODY_MASS][k];
      m_sum += m;
      for (int i = 0; i < 3; ++i) p[i] += m * xipos[3 * k + i];
    }
    const float w = fmaxf(m_sum, 1e-12f);
    for (int i = 0; i < 3; ++i) com[3 * b + i] = p[i] / w;
  }
  __syncwarp();
  flush(com, O[SUBTREE_COM], 3 * nb, lane);
  __syncwarp();

  // cdof, one dof per joint: [axis; axis x (root com - anchor)] for a
  // hinge, [0; axis] for a slide.
  for (int j = lane; j < nj; j += 32) {
    const float* c = com + 3 * body_rootid[jnt_bodyid[j]];
    const float* ax = xax + 3 * j;
    const float* an = xanc + 3 * j;
    float* o = stage + 6 * j;
    if (jnt_type[j] == kHinge) {
      const float off[3] = {c[0] - an[0], c[1] - an[1], c[2] - an[2]};
      float lin[3];
      cross(ax, off, lin);
      for (int i = 0; i < 3; ++i) { o[i] = ax[i]; o[3 + i] = lin[i]; }
    } else {
      for (int i = 0; i < 3; ++i) { o[i] = 0.0f; o[3 + i] = ax[i]; }
    }
  }
  __syncwarp();
  flush(stage, O[CDOF], 6 * nj, lane);
  __syncwarp();

  // Spatial inertia about the tree root's com, world axes
  // (maths.spatial_inertia with inert_world = R diag(I) R^T):
  // rows 0-2 [I_shift | m skew(d)], rows 3-5 [m skew(d)^T | m I].
  // A record per body, then the 36 elements of each over the lanes.
  for (int b = lane; b < nb; b += 32) {
    float qi[4], R[9];
    qmul(xquat + 4 * b, F[BODY_IQUAT] + 4 * b, qi);
    q2m(qi, R);
    const float* I3 = F[BODY_INERTIA] + 3 * b;
    float* rec = stage + kRec * b;
    for (int i = 0; i < 3; ++i)
      for (int k = 0; k < 3; ++k)
        rec[3 * i + k] = R[3 * i + 0] * I3[0] * R[3 * k + 0]
                       + R[3 * i + 1] * I3[1] * R[3 * k + 1]
                       + R[3 * i + 2] * I3[2] * R[3 * k + 2];
    const float* c = com + 3 * body_rootid[b];
    const float dv[3] = {xipos[3 * b] - c[0], xipos[3 * b + 1] - c[1],
                         xipos[3 * b + 2] - c[2]};
    for (int i = 0; i < 3; ++i) rec[9 + i] = dv[i];
    rec[12] = dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2];
    rec[13] = F[BODY_MASS][b];
  }
  __syncwarp();
  float* cinert = O[CINERT];
  for (int e = lane; e < 36 * nb; e += 32) {
    const int b = e / 36, r = e - 36 * b, i = r / 6, k = r - 6 * i;
    const float* rec = stage + kRec * b;
    const float* dv = rec + 9;
    const float m = rec[13];
    float v;
    if (i < 3 && k < 3)
      v = rec[3 * i + k] + m * ((i == k ? rec[12] : 0.0f) - dv[i] * dv[k]);
    else if (i < 3)
      v = m * skew(dv, i, k - 3);
    else if (k < 3)
      v = m * skew(dv, k, i - 3);
    else
      v = i == k ? m : 0.0f;
    cinert[e] = v;
  }
}

}  // namespace

// in[12] / in_stride[12] / out[13] are host arrays (the field order of
// the enums above); tab is a device int32 table of ntab entries, whose
// length gives the number of levels.  Returns cudaErrorInvalidValue for
// a table of no body or no level, or a block above kMaxSmem bytes of
// shared memory.
extern "C" int fk(const float* qpos, const int* tab, const float* const* in,
                  const long long* in_stride, float* const* out, int B,
                  int nq, int nbody, int njnt, int ngeom, int nsite,
                  int ntab, void* stream) {
  const int nlevel = ntab - (5 * nbody + 1 + 4 * njnt + ngeom + nsite) - 1;
  if (nbody < 1 || nlevel < 1) return (int)cudaErrorInvalidValue;
  FkArgs a;
  for (int k = 0; k < N_IN; ++k) {
    a.in[k] = in[k];
    a.in_stride[k] = in_stride[k];
  }
  for (int k = 0; k < N_OUT; ++k) a.out[k] = out[k];
  Dims d{nq, nbody, njnt, ngeom, nsite, nlevel, ntab, 0};
  d.warp_floats = nq + in_floats(d) + 13 * nbody + 6 * njnt + stage_floats(d);
  const size_t smem = (size_t)ntab * sizeof(int)
                    + (size_t)kWarps * d.warp_floats * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + kWarps - 1) / kWarps;
  if (blocks > 0)
    fk_kernel<<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
        qpos, tab, a, B, d);
  return (int)cudaGetLastError();
}
