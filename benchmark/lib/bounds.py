"""The least time each hand-written kernel of the step (K1-K6) could take,
from its launch's shapes: the larger of its bytes over the card's memory
rate and its float32 operations over the float32 rate.

The counts are frozen from the port's kernel table (PERF.md, findings,
"Kernel table"; `chip_smoke.py` `bound`, `fk_bytes`, `fk_flops`): each
input read once and each output written once; K2 and K4 read one
triangle of the symmetric H, K3 one triangle of the factor; K5 counts 8
operations a row for each of its 12 bracket phi' evaluations, 16 for
each of its (phi', phi'') steps and 12 for the cost pass; K6 one sweep,
the least any env runs.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM, published peaks (data sheet) at the 700 W limit: HBM3
# bytes/s, and float32 operations/s outside the tensor cores.
BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F32 = 4

JNT_HINGE, JNT_SLIDE = 3, 2

# The model fields the FK kernel reads (fk.cu's order).
FK_FIELDS = ("body_pos", "body_quat", "body_ipos", "body_iquat", "jnt_pos",
             "jnt_axis", "geom_pos", "geom_quat", "site_pos", "site_quat",
             "body_mass", "body_inertia")


def seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / BYTES_PER_S, flops / F32_FLOPS)


def _tri(nv: int) -> int:
    return nv * (nv + 1) // 2


def fk_table_ints(s) -> int:
    """int32 entries of the FK kernel's tree table."""
    parent = np.asarray(s.body_parentid, dtype=np.int64)
    depth = np.zeros(s.nbody, dtype=np.int64)
    for b in range(1, s.nbody):
        depth[b] = depth[parent[b]] + 1
    nlevel = int(depth.max()) + 1
    return 5 * s.nbody + 1 + 4 * s.njnt + s.ngeom + s.nsite + nlevel + 1


def fk_flops(s) -> float:
    """float32 operations of one env's FK: a quaternion product 28, a
    rotation 30, a rotation matrix 30, a unit quaternion 13, sin and cos
    one each."""
    jt = np.asarray(s.jnt_type)
    n_hinge = int((jt == JNT_HINGE).sum())
    n_slide = int((jt == JNT_SLIDE).sum())
    return ((s.nbody - 1) * (61 + 4) + n_hinge * (176 + 12) + n_slide * 99
            + s.nbody * (66 + 4 + 192) + (s.ngeom + s.nsite) * 91)


def fk(m, qpos, *_, **__) -> float:
    """K1 (`kinematics.fk_cuda(m, qpos)`)."""
    s = m.spec
    B = qpos.shape[0]
    n = B * s.nq + fk_table_ints(s)
    n += sum(getattr(m, f).numel() for f in FK_FIELDS)
    nb, nj, ng, ns = s.nbody, s.njnt, s.ngeom, s.nsite
    n += B * (nb * (3 + 4 + 9 + 3 + 3 + 36) + ng * 12 + ns * 12 + nj * 12)
    return seconds(n * F32, B * fk_flops(s))


def chol_factor(H, *_, **__) -> float:
    """K2 (`kernels.chol_factor_cuda(H)`)."""
    B, nv = H.shape[0], H.shape[-1]
    return seconds(B * (_tri(nv) + nv * nv) * F32, B * nv ** 3 / 3)


def chol_solve_fac(fac, G, *_, **__) -> float:
    """K3 (`kernels.chol_solve_fac_cuda(fac, G)`), R right-hand sides."""
    B, nv, R = G.shape
    return seconds(B * (_tri(nv) + 2 * nv * R) * F32, 2 * B * nv * nv * R)


def chol_factor_solve(H, g, *_, **__) -> float:
    """K4 (`kernels.chol_factor_solve_cuda(H, g)`)."""
    B, nv = g.shape
    return seconds(B * (_tri(nv) + 2 * nv) * F32,
                   B * (nv ** 3 / 3 + 2 * nv * nv))


def linesearch_cost(jar, Jp, D, floss, active, c1, c2,
                    bracket_iters: int = 12, ls_iters: int = 16,
                    *_, **__) -> float:
    """K5 (`kernels.linesearch_cost_cuda`)."""
    B, R = jar.shape
    return seconds(B * R * (4 * F32 + 1) + 4 * B * F32,
                   B * R * (bracket_iters * 8 + ls_iters * 16 + 12))


def noslip_sweep(A, *_, **__) -> float:
    """K6 (`kernels.noslip_sweep_cuda`), one sweep."""
    B, R = A.shape[0], A.shape[-1]
    return seconds(B * R * (R + 7) * F32, B * R * (2 * R + 6))


# The port's launch functions of K1-K6, and the names of the CUDA kernels
# they launch (one each a call).
LAUNCHES = {
    "mj_envs_torch.physics.kinematics:fk_cuda": fk,
    "mj_envs_torch.physics.kernels:chol_factor_cuda": chol_factor,
    "mj_envs_torch.physics.kernels:chol_solve_fac_cuda": chol_solve_fac,
    "mj_envs_torch.physics.kernels:chol_factor_solve_cuda": chol_factor_solve,
    "mj_envs_torch.physics.kernels:linesearch_cost_cuda": linesearch_cost,
    "mj_envs_torch.physics.kernels:noslip_sweep_cuda": noslip_sweep,
}
KERNEL_NAMES = ("fk_kernel", "chol_factor_kernel", "chol_subst_cols_kernel",
                "chol_subst_warp_kernel", "chol_factor_solve_kernel",
                "linesearch_kernel", "noslip_warp_kernel")
