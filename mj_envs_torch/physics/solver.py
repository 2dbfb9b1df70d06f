"""Constraint solver (`mj_envs_tpu/physics/solver.py`, float32 path):
primal Newton over qacc with an exact linesearch and the fused cost
carry, then the noslip post-pass, batch-first.

The problem is strictly convex:

  min_qacc 0.5 (qacc - qacc_smooth)^T M (qacc - qacc_smooth) + sum_i s_i(jar_i)

with jar = J qacc - aref; one-sided rows are quadratic for jar < 0,
friction-loss rows are Huber.  The JAX package runs the Newton loop as a
batched `while_loop`: every env's carry freezes once its own
`(it < iterations) & ~done` turns false, and the loop ends when no env
is left.  Here that is a per-env `running` mask with `torch.where` on the
carry; the kernels still run on the whole batch each iteration.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import kernels
from .constraint import Rows, j_matvec, jt_matvec, jtwj

# Newton exit: cost improvement <= NEWTON_TOL_SCALE * eps(f32) relative
# (solver.py's f32 default), and the noslip sweep's early-exit tolerance
# relative to the force scale (its f32 default; CUDA path only).
NEWTON_TOL_SCALE = 300.0
NOSLIP_TOL = 1e-3


def _forces(rows: Rows, jar: torch.Tensor):
    """Constraint force f(jar) and the active-quadratic mask."""
    is_fric = rows.floss > 0
    f_quad = -rows.D * jar
    f_fric = torch.minimum(torch.maximum(f_quad, -rows.floss), rows.floss)
    f_one = torch.where(jar < 0, f_quad, torch.zeros_like(jar))
    f = torch.where(is_fric, f_fric, f_one)
    quad = torch.where(is_fric, f_quad.abs() <= rows.floss, jar < 0) \
        & rows.active
    return f * rows.active, quad


def _cost_rows(rows: Rows, jar: torch.Tensor) -> torch.Tensor:
    return (kernels.row_cost(jar, rows.D, rows.floss) * rows.active).sum(-1)


def _quad(M, v):
    """0.5 v^T M v per env."""
    return 0.5 * (v * torch.matmul(M, v[..., None])[..., 0]).sum(-1)


def _total_cost(M, qacc, qacc_smooth, rows, jar):
    return _quad(M, qacc - qacc_smooth) + _cost_rows(rows, jar)


class SolveResult(NamedTuple):
    qacc: torch.Tensor        # (B, nv)
    efc_force: torch.Tensor   # (B, nefc)
    jar: torch.Tensor         # (B, nefc)


def newton_solve(M: torch.Tensor, qacc_smooth: torch.Tensor, rows: Rows,
                 qacc_warmstart: torch.Tensor, iterations: int,
                 ls_iterations: int = 16,
                 tol_scale: float = NEWTON_TOL_SCALE) -> SolveResult:
    # Start from the lower-cost of warmstart / smooth (mj_fwdConstraint).
    jar_s = j_matvec(rows, qacc_smooth) - rows.aref
    jar_w = j_matvec(rows, qacc_warmstart) - rows.aref
    cost_s = _total_cost(M, qacc_smooth, qacc_smooth, rows, jar_s)
    cost_w = _total_cost(M, qacc_warmstart, qacc_smooth, rows, jar_w)
    use_w = cost_w < cost_s
    qacc = torch.where(use_w[:, None], qacc_warmstart, qacc_smooth)
    jar = torch.where(use_w[:, None], jar_w, jar_s)

    B, nv = qacc.shape
    eye = torch.eye(nv, dtype=qacc.dtype, device=qacc.device)
    tol_rel = tol_scale * torch.finfo(qacc.dtype).eps
    cost = torch.where(use_w, cost_w, cost_s)
    quad_cost = _quad(M, qacc - qacc_smooth)

    it = torch.zeros(B, dtype=torch.int32, device=qacc.device)
    done = torch.zeros(B, dtype=torch.bool, device=qacc.device)
    running = (it < iterations) & ~done
    while bool(running.any()):
        f, quad = _forces(rows, jar)
        dq = qacc - qacc_smooth
        Mdq = torch.matmul(M, dq[..., None])[..., 0]
        grad = Mdq - jt_matvec(rows, f)
        H = M + jtwj(rows, torch.where(quad, rows.D, torch.zeros_like(rows.D)))
        # Levenberg guard against f32 roundoff pushing H indefinite.
        lm = 10.0 * torch.finfo(qacc.dtype).eps \
            * torch.diagonal(H, dim1=-2, dim2=-1).mean(-1)
        p = -kernels.chol_solve(H + lm[:, None, None] * eye, grad)
        # A failed factorization (NaN) falls back to a diagonally
        # preconditioned gradient step.
        p_ok = torch.isfinite(p).all(-1, keepdim=True)
        p = torch.where(p_ok, p, -grad / torch.clamp(
            torch.diagonal(H, dim1=-2, dim2=-1), min=1e-8))
        Jp = j_matvec(rows, p)
        c1 = (p * Mdq).sum(-1)
        c2 = (p * torch.matmul(M, p[..., None])[..., 0]).sum(-1)
        alpha, rows_cost = kernels.linesearch_cost(
            jar, Jp, rows.D, rows.floss, rows.active, c1, c2,
            12, ls_iterations)
        quad_new = quad_cost + alpha * c1 + 0.5 * alpha * alpha * c2
        cost_new = quad_new + rows_cost
        improved = cost - cost_new
        done_new = improved <= tol_rel * (1.0 + cost_new.abs())
        # Reject non-improving steps (keeps the fixed point stable).
        keep = (improved >= 0) & running
        qacc = torch.where(keep[:, None], qacc + alpha[:, None] * p, qacc)
        jar = torch.where(keep[:, None], jar + alpha[:, None] * Jp, jar)
        cost = torch.where(keep, cost_new, cost)
        quad_cost = torch.where(keep, quad_new, quad_cost)
        it = torch.where(running, it + 1, it)
        done = torch.where(running, done_new, done)
        running = (it < iterations) & ~done
    f, _ = _forces(rows, jar)
    return SolveResult(qacc=qacc, efc_force=f, jar=jar)


def noslip(M: torch.Tensor, rows: Rows, res: SolveResult, n_fric_dof: int,
           ncmax: int, iterations: int, M_fac: torch.Tensor,
           tol: float = NOSLIP_TOL) -> SolveResult:
    """Noslip post-pass: Gauss-Seidel over the friction rows only, without
    regularization — dof friction-loss rows box-clamped to
    +-frictionloss, and per contact facet pair the difference updated
    with the sum (the normal force) held fixed.  X = M^-1 D^T comes from
    the mass-matrix factor `M_fac` of `kernels.chol_solve_factor`."""
    B, nefc = rows.aref.shape
    nv = M.shape[-1]
    dtype = M.dtype
    con_base = nefc - ncmax * 6

    # Facet +/- pairs are adjacent rows of the contact block:
    # Jd = (J+ - J-) / 2 = mu Jt, bd = (aref+ - aref-) / 2.
    Jcon = rows.J[:, con_base:].reshape(B, ncmax * 3, 2, nv)
    Jd_pairs = 0.5 * (Jcon[:, :, 0] - Jcon[:, :, 1])
    acon = rows.aref[:, con_base:].reshape(B, ncmax * 3, 2)
    bd_pairs = 0.5 * (acon[..., 0] - acon[..., 1])
    D_all = torch.cat([rows.J[:, :n_fric_dof], Jd_pairs], dim=1)  # (B, R, nv)
    b_all = torch.cat([rows.aref[:, :n_fric_dof], bd_pairs], dim=1)

    X = kernels.chol_solve_mat_fac(M_fac, D_all.transpose(-1, -2))  # (B,nv,R)
    a_diag = (D_all.transpose(-1, -2) * X).sum(-2)                 # (B, R)
    a_safe = torch.where(a_diag > 1e-12, a_diag, torch.ones_like(a_diag))

    fl_dof = rows.floss[:, :n_fric_dof]
    actcon = rows.active[:, con_base:].reshape(B, ncmax * 3, 2)
    active_pairs = actcon[..., 0] & actcon[..., 1]
    f_dof0 = res.efc_force[:, :n_fric_dof]
    fcon0 = res.efc_force[:, con_base:].reshape(B, ncmax * 3, 2)
    fp0, fm0 = fcon0[..., 0], fcon0[..., 1]
    u0 = torch.cat([f_dof0, fp0 - fm0], dim=1)
    ssum = fp0 + fm0
    lo = torch.cat([-fl_dof, -ssum], dim=1)
    hi = torch.cat([fl_dof, ssum], dim=1)
    live = torch.cat([torch.ones_like(fl_dof, dtype=torch.bool),
                      active_pairs], dim=1)

    # Residual form: r = D qacc - b, A = D M^-1 D^T.
    A = torch.matmul(D_all, X)                                     # (B, R, R)
    gate = (live & (a_diag > 1e-12)).to(dtype)
    r0 = torch.matmul(D_all, res.qacc[..., None])[..., 0] - b_all
    u = kernels.noslip_sweep(A, a_safe, lo, hi, gate, r0, u0, iterations, tol)
    qacc = res.qacc + torch.matmul(X, (u - u0)[..., None])[..., 0]

    f_dof = u[:, :n_fric_dof]
    ud = u[:, n_fric_dof:]
    fp = 0.5 * (ssum + ud)
    fm = 0.5 * (ssum - ud)
    inter = torch.stack([fp, fm], dim=-1).reshape(B, ncmax * 6)
    efc = torch.cat([f_dof, res.efc_force[:, n_fric_dof:con_base], inter],
                    dim=1)
    jar = j_matvec(rows, qacc) - rows.aref
    return SolveResult(qacc=qacc, efc_force=efc, jar=jar)
