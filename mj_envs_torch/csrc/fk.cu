// Fused forward kinematics: the whole FK of one env in one thread.
//
// Replaces mj_envs_tpu/physics/fk_kernel.py:_fk_kernel (fk_pallas):
// body tree walk (parent frame, body offset, the body's hinge/slide
// joints in order), xpos/xquat/xmat, xipos, geom and site poses, joint
// anchors and axes, subtree com (leaf-to-root), cdof and the 6x6 cinert
// about each tree root's subtree com.  The arithmetic is that of the
// plain version (mj_envs_torch/physics/kinematics.py kinematics_plain,
// maths.py): a hinge's quaternion is renormalised after it is composed
// (sqrt, divide by max(n, 1e-15)); its anchor is taken before the
// rotation and the position re-derived after it; sinf/cosf of q / 2.
//
// One kernel serves every task: the static tree arrives as an int32
// table (layout below) built once per model by the wrapper, and each
// model field has a batch stride, 0 where the field is shared by all
// envs and the per-env size where the env carries its own copy (the
// task's ModelVar), so shared fields are never broadcast to B copies.
//
// Bound on the card: memory.  Per env (hammer) the outputs are ~3.1k
// floats, the inputs qpos and the per-env fields, ~12.8 KB in all: at
// B = 512 about 6.6 MB, 2 us at 3.35 TB/s; the arithmetic is ~25k flops
// per env.  What costs time here is the serial walk: one thread per env,
// so B = 512 envs fill 16 blocks of 32 threads, and each thread's
// outputs are written batch-first (uncoalesced).  Simple and right
// first; the layout is left to a later change.
//
// Table layout (int32): parent[nbody] | jnt_adr[nbody + 1] (the joints of
// body b are jnt_order[jnt_adr[b] .. jnt_adr[b + 1]]) | jnt_order[njnt] |
// jnt_type[njnt] | jnt_qposadr[njnt] | jnt_bodyid[njnt] |
// geom_bodyid[ngeom] | site_bodyid[nsite] | body_rootid[nbody].
#include <cuda_runtime.h>

namespace {

constexpr int kMaxBody = 64;
constexpr int kThreads = 32;
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
  float r[3], q[4], m[9];
  qrot(xq, lp, r);
  for (int i = 0; i < 3; ++i) pos_out[i] = xp[i] + r[i];
  qmul(xq, lq, q);
  q2m(q, m);
  for (int i = 0; i < 9; ++i) mat_out[i] = m[i];
}

__global__ void __launch_bounds__(kThreads)
fk_kernel(const float* __restrict__ qpos, const int* __restrict__ tab_g,
          FkArgs a, int B, int nq, int nbody, int njnt, int ngeom,
          int nsite, int ntab) {
  extern __shared__ int tab[];
  for (int i = threadIdx.x; i < ntab; i += blockDim.x) tab[i] = tab_g[i];
  __syncthreads();
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= B) return;

  const int* parent = tab;
  const int* jnt_adr = parent + nbody;
  const int* jnt_order = jnt_adr + nbody + 1;
  const int* jnt_type = jnt_order + njnt;
  const int* jnt_qposadr = jnt_type + njnt;
  const int* jnt_bodyid = jnt_qposadr + njnt;
  const int* geom_bodyid = jnt_bodyid + njnt;
  const int* site_bodyid = geom_bodyid + ngeom;
  const int* body_rootid = site_bodyid + nsite;

  const float* F[N_IN];
  for (int k = 0; k < N_IN; ++k) F[k] = a.in[k] + env * a.in_stride[k];
  const float* q = qpos + (size_t)env * nq;
  float* xpos_o = a.out[XPOS] + (size_t)env * nbody * 3;
  float* xquat_o = a.out[XQUAT] + (size_t)env * nbody * 4;
  float* xmat_o = a.out[XMAT] + (size_t)env * nbody * 9;
  float* xipos_o = a.out[XIPOS] + (size_t)env * nbody * 3;
  float* gpos_o = a.out[GEOM_XPOS] + (size_t)env * ngeom * 3;
  float* gmat_o = a.out[GEOM_XMAT] + (size_t)env * ngeom * 9;
  float* spos_o = a.out[SITE_XPOS] + (size_t)env * nsite * 3;
  float* smat_o = a.out[SITE_XMAT] + (size_t)env * nsite * 9;
  float* xanchor_o = a.out[XANCHOR] + (size_t)env * njnt * 3;
  float* xaxis_o = a.out[XAXIS] + (size_t)env * njnt * 3;
  float* com_o = a.out[SUBTREE_COM] + (size_t)env * nbody * 3;
  float* cdof_o = a.out[CDOF] + (size_t)env * njnt * 6;
  float* cinert_o = a.out[CINERT] + (size_t)env * nbody * 36;

  float xpos[kMaxBody][3], xquat[kMaxBody][4];
  xpos[0][0] = xpos[0][1] = xpos[0][2] = 0.0f;
  xquat[0][0] = 1.0f;
  xquat[0][1] = xquat[0][2] = xquat[0][3] = 0.0f;

  // Tree walk in body order (parents come first).
  for (int b = 1; b < nbody; ++b) {
    const int p = parent[b];
    float pq[4], pp[3], r[3];
    qmul(xquat[p], F[BODY_QUAT] + 4 * b, pq);
    qrot(xquat[p], F[BODY_POS] + 3 * b, r);
    for (int i = 0; i < 3; ++i) pp[i] = xpos[p][i] + r[i];
    for (int t = jnt_adr[b]; t < jnt_adr[b + 1]; ++t) {
      const int j = jnt_order[t];
      const float qj = q[jnt_qposadr[j]];
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
      for (int i = 0; i < 3; ++i) xanchor_o[3 * j + i] = pp[i] + r[i];
      qrot(pq, axis, r);
      for (int i = 0; i < 3; ++i) xaxis_o[3 * j + i] = r[i];
    }
    for (int i = 0; i < 3; ++i) xpos[b][i] = pp[i];
    for (int i = 0; i < 4; ++i) xquat[b][i] = pq[i];
  }

  // Body frames and inertial frames; (mass, mass * xipos) per body for
  // the subtree sums.
  float xipos[kMaxBody][3], acc_m[kMaxBody], acc_p[kMaxBody][3];
  for (int b = 0; b < nbody; ++b) {
    float r[3];
    for (int i = 0; i < 3; ++i) xpos_o[3 * b + i] = xpos[b][i];
    for (int i = 0; i < 4; ++i) xquat_o[4 * b + i] = xquat[b][i];
    q2m(xquat[b], xmat_o + 9 * b);
    qrot(xquat[b], F[BODY_IPOS] + 3 * b, r);
    const float m = F[BODY_MASS][b];
    acc_m[b] = m;
    for (int i = 0; i < 3; ++i) {
      xipos[b][i] = xpos[b][i] + r[i];
      xipos_o[3 * b + i] = xipos[b][i];
      acc_p[b][i] = m * xipos[b][i];
    }
  }
  for (int g = 0; g < ngeom; ++g) {
    const int b = geom_bodyid[g];
    attach(xpos[b], xquat[b], F[GEOM_POS] + 3 * g, F[GEOM_QUAT] + 4 * g,
           gpos_o + 3 * g, gmat_o + 9 * g);
  }
  for (int s = 0; s < nsite; ++s) {
    const int b = site_bodyid[s];
    attach(xpos[b], xquat[b], F[SITE_POS] + 3 * s, F[SITE_QUAT] + 4 * s,
           spos_o + 3 * s, smat_o + 9 * s);
  }

  // Subtree com, leaf-to-root (children have larger ids than parents).
  for (int b = nbody - 1; b > 0; --b) {
    const int p = parent[b];
    acc_m[p] += acc_m[b];
    for (int i = 0; i < 3; ++i) acc_p[p][i] += acc_p[b][i];
  }
  for (int b = 0; b < nbody; ++b) {
    const float w = fmaxf(acc_m[b], 1e-12f);
    for (int i = 0; i < 3; ++i) {
      acc_p[b][i] = acc_p[b][i] / w;  // now the subtree com
      com_o[3 * b + i] = acc_p[b][i];
    }
  }

  // cdof, one dof per joint: [axis; axis x (root com - anchor)] for a
  // hinge, [0; axis] for a slide.
  for (int j = 0; j < njnt; ++j) {
    const float* c = acc_p[body_rootid[jnt_bodyid[j]]];
    const float* ax = xaxis_o + 3 * j;
    const float* an = xanchor_o + 3 * j;
    float* o = cdof_o + 6 * j;
    if (jnt_type[j] == kHinge) {
      const float off[3] = {c[0] - an[0], c[1] - an[1], c[2] - an[2]};
      float lin[3];
      cross(ax, off, lin);
      for (int i = 0; i < 3; ++i) { o[i] = ax[i]; o[3 + i] = lin[i]; }
    } else {
      for (int i = 0; i < 3; ++i) { o[i] = 0.0f; o[3 + i] = ax[i]; }
    }
  }

  // Spatial inertia about the tree root's com, world axes
  // (maths.spatial_inertia with inert_world = R diag(I) R^T):
  // rows 0-2 [I_shift | m skew(d)], rows 3-5 [m skew(d)^T | m I].
  for (int b = 0; b < nbody; ++b) {
    float qi[4], R[9], iw[9];
    qmul(xquat[b], F[BODY_IQUAT] + 4 * b, qi);
    q2m(qi, R);
    const float* I3 = F[BODY_INERTIA] + 3 * b;
    for (int i = 0; i < 3; ++i)
      for (int k = 0; k < 3; ++k)
        iw[3 * i + k] = R[3 * i + 0] * I3[0] * R[3 * k + 0]
                      + R[3 * i + 1] * I3[1] * R[3 * k + 1]
                      + R[3 * i + 2] * I3[2] * R[3 * k + 2];
    const float m = F[BODY_MASS][b];
    const float* c = acc_p[body_rootid[b]];
    const float d[3] = {xipos[b][0] - c[0], xipos[b][1] - c[1],
                        xipos[b][2] - c[2]};
    const float dd = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    const float sk[9] = {0.0f, -d[2], d[1], d[2], 0.0f, -d[0],
                         -d[1], d[0], 0.0f};
    float* o = cinert_o + 36 * b;
    for (int i = 0; i < 3; ++i) {
      for (int k = 0; k < 3; ++k) {
        const float diag = (i == k) ? dd : 0.0f;
        o[6 * i + k] = iw[3 * i + k] + m * (diag - d[i] * d[k]);
        o[6 * i + 3 + k] = m * sk[3 * i + k];
        o[6 * (3 + i) + k] = m * sk[3 * k + i];
        o[6 * (3 + i) + 3 + k] = (i == k) ? m : 0.0f;
      }
    }
  }
}

}  // namespace

// in[12] / in_stride[12] / out[13] are host arrays (the field order of
// the enums above); tab is a device int32 table of ntab entries.
// Returns cudaErrorInvalidValue for a model above kMaxBody bodies.
extern "C" int fk(const float* qpos, const int* tab, const float* const* in,
                  const long long* in_stride, float* const* out, int B,
                  int nq, int nbody, int njnt, int ngeom, int nsite,
                  int ntab, void* stream) {
  if (nbody > kMaxBody || nbody < 1) return (int)cudaErrorInvalidValue;
  FkArgs a;
  for (int k = 0; k < N_IN; ++k) {
    a.in[k] = in[k];
    a.in_stride[k] = in_stride[k];
  }
  for (int k = 0; k < N_OUT; ++k) a.out[k] = out[k];
  const int blocks = (B + kThreads - 1) / kThreads;
  if (blocks > 0)
    fk_kernel<<<blocks, kThreads, (size_t)ntab * sizeof(int),
                (cudaStream_t)stream>>>(qpos, tab, a, B, nq, nbody, njnt,
                                        ngeom, nsite, ntab);
  return (int)cudaGetLastError();
}
