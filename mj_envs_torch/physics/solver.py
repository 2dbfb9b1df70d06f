"""Constraint solver (`mj_envs_tpu/physics/solver.py`): primal Newton
over qacc with an exact linesearch, then the noslip post-pass,
batch-first.

The problem is strictly convex:

  min_qacc 0.5 (qacc - qacc_smooth)^T M (qacc - qacc_smooth) + sum_i s_i(jar_i)

with jar = J qacc - aref; one-sided rows are quadratic for jar < 0,
friction-loss rows are Huber.  The JAX package runs the Newton loop as a
batched `while_loop`: every env's carry freezes once its own
`(it < iterations) & ~done` turns false, and the loop ends when no env
is left.  Here that is a per-env `running` mask with `torch.where` on the
carry; the kernels still run on the whole batch each iteration.

Two paths, as in the JAX package.  float32: the fused linesearch-cost
kernel and an incrementally carried quadratic cost, the Newton exit at
`tol_scale` eps (MJE_NEWTON_TOL_SCALE), the noslip X = M^-1 D^T from the
mass-matrix factor and the sweep's exit tolerance (MJE_NOSLIP_TOL, on
the card).  float64, the oracle-parity path: the alpha-only linesearch,
the total cost recomputed after each step, the exit at exactly 10 eps,
noslip through inv(M) and its fixed sweeps; both knobs are ignored.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from .. import trace
from . import kernels
from .constraint import Rows, j_matvec, jt_matvec, jtwj

# Newton exit: cost improvement <= NEWTON_TOL_SCALE * eps(f32) relative
# (solver.py's f32 default), and the noslip sweep's early-exit tolerance
# relative to the force scale (its f32 default; CUDA path only).
NEWTON_TOL_SCALE = 300.0
NOSLIP_TOL = 1e-3
# The float64 path's fixed Newton exit, in units of eps(f64).
F64_NEWTON_TOL_SCALE = 10.0


def newton_tol_scale() -> float:
    """The f32 Newton exit in units of eps: MJE_NEWTON_TOL_SCALE, as the
    JAX package reads it (default NEWTON_TOL_SCALE)."""
    return float(os.environ.get("MJE_NEWTON_TOL_SCALE", NEWTON_TOL_SCALE))


def noslip_tol() -> float:
    """The f32 noslip sweep's exit tolerance: MJE_NOSLIP_TOL, as the JAX
    package reads it (default NOSLIP_TOL; 0 runs every sweep)."""
    return float(os.environ.get("MJE_NOSLIP_TOL", NOSLIP_TOL))


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
    """Newton over qacc.  float32 exits at `tol_scale` eps and carries
    the cost through the fused linesearch kernel; float64 exits at
    F64_NEWTON_TOL_SCALE eps whatever `tol_scale` says, and recomputes
    the total cost after each step (the JAX package's non-fused loop)."""
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
    fused = qacc.dtype == torch.float32
    if not fused:
        tol_scale = F64_NEWTON_TOL_SCALE
    tol_rel = tol_scale * torch.finfo(qacc.dtype).eps
    cost = torch.where(use_w, cost_w, cost_s)
    quad_cost = _quad(M, qacc - qacc_smooth) if fused else None

    it = torch.zeros(B, dtype=torch.int32, device=qacc.device)
    done = torch.zeros(B, dtype=torch.bool, device=qacc.device)
    running = (it < iterations) & ~done
    slots = env_iters = 0
    while n_running := _loop_test(running):
        slots += B
        env_iters += n_running
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
        if fused:
            alpha, rows_cost = kernels.linesearch_cost(
                jar, Jp, rows.D, rows.floss, rows.active, c1, c2,
                12, ls_iterations)
            quad_new = quad_cost + alpha * c1 + 0.5 * alpha * alpha * c2
            cost_new = quad_new + rows_cost
            qacc_new = qacc + alpha[:, None] * p
            jar_new = jar + alpha[:, None] * Jp
        else:
            alpha = kernels.linesearch(
                jar, Jp, rows.D, rows.floss, rows.active, c1, c2,
                12, ls_iterations)
            qacc_new = qacc + alpha[:, None] * p
            jar_new = jar + alpha[:, None] * Jp
            cost_new = _total_cost(M, qacc_new, qacc_smooth, rows, jar_new)
        improved = cost - cost_new
        done_new = improved <= tol_rel * (1.0 + cost_new.abs())
        # Reject non-improving steps (keeps the fixed point stable).
        keep = (improved >= 0) & running
        qacc = torch.where(keep[:, None], qacc_new, qacc)
        jar = torch.where(keep[:, None], jar_new, jar)
        cost = torch.where(keep, cost_new, cost)
        if fused:
            quad_cost = torch.where(keep, quad_new, quad_cost)
        it = torch.where(running, it + 1, it)
        done = torch.where(running, done_new, done)
        running = (it < iterations) & ~done
    trace.count("newton.solves", B)
    trace.count("newton.slots", slots)
    trace.count("newton.env_iters", env_iters)
    f, _ = _forces(rows, jar)
    return SolveResult(qacc=qacc, efc_force=f, jar=jar)


def _loop_test(running: torch.Tensor) -> int:
    """The Newton loop's test, its one read of the device each
    iteration: with the tracer on, how many envs still run (summed over
    the iterations, each env's own iteration count: `newton.env_iters`),
    else whether any does."""
    return int(running.sum()) if trace.enabled() else bool(running.any())


class NoslipProblem(NamedTuple):
    """The sweep problem of `noslip` (the arguments of
    `kernels.noslip_sweep` before `iterations`) and what maps its
    solution back: X = M^-1 D^T and each contact pair's force sum."""
    A: torch.Tensor       # (B, R, R) = D M^-1 D^T
    a_safe: torch.Tensor  # (B, R)
    lo: torch.Tensor      # (B, R)
    hi: torch.Tensor      # (B, R)
    gate: torch.Tensor    # (B, R)
    r0: torch.Tensor      # (B, R)
    u0: torch.Tensor      # (B, R)
    X: torch.Tensor       # (B, nv, R)
    ssum: torch.Tensor    # (B, ncmax * 3)
    # float64 only: inv(M) and D, for the JAX package's qacc update
    # Minv (D^T (u - u0)).
    Minv: Optional[torch.Tensor] = None    # (B, nv, nv)
    D_all: Optional[torch.Tensor] = None   # (B, R, nv)


def noslip_problem(M: torch.Tensor, rows: Rows, res: SolveResult,
                   n_fric_dof: int, ncmax: int,
                   M_fac: torch.Tensor | None = None) -> NoslipProblem:
    """Assemble `noslip`'s Gauss-Seidel problem over the friction rows:
    the dof friction-loss rows and, per contact facet pair, the
    difference of the pair (with `rows.Jbase`, its base rows 1..3).  In
    float32 X = M^-1 D^T comes from the mass-matrix factor `M_fac` of
    `kernels.chol_solve_factor` or, without one, from factoring M here
    (`kernels.chol_solve_mat`); in float64 from inv(M), as the JAX
    package's oracle-parity path computes it."""
    B, nefc = rows.aref.shape
    nv = M.shape[-1]
    dtype = M.dtype
    con_base = nefc - ncmax * 6

    # Facet +/- pairs are adjacent rows of the contact block:
    # Jd = (J+ - J-) / 2 = mu Jt, bd = (aref+ - aref-) / 2.  In the
    # base-compressed layout the direction rows mu_d Jt_d are Jbase's
    # rows 1..3 of each contact.
    if rows.Jbase is not None:
        Jd_pairs = rows.Jbase.reshape(B, ncmax, 4, nv)[:, :, 1:4] \
            .reshape(B, ncmax * 3, nv)
    else:
        Jcon = rows.J[:, con_base:].reshape(B, ncmax * 3, 2, nv)
        Jd_pairs = 0.5 * (Jcon[:, :, 0] - Jcon[:, :, 1])
    acon = rows.aref[:, con_base:].reshape(B, ncmax * 3, 2)
    bd_pairs = 0.5 * (acon[..., 0] - acon[..., 1])
    D_all = torch.cat([rows.J[:, :n_fric_dof], Jd_pairs], dim=1)  # (B, R, nv)
    b_all = torch.cat([rows.aref[:, :n_fric_dof], bd_pairs], dim=1)

    Dt = D_all.transpose(-1, -2)
    Minv = None
    if dtype == torch.float64:
        Minv = torch.linalg.inv(M)
        MD = torch.matmul(D_all, Minv)                             # (B, R, nv)
        a_diag = (MD * D_all).sum(-1)                              # (B, R)
        X = MD.transpose(-1, -2)                                   # (B,nv,R)
    else:
        X = kernels.chol_solve_mat(M, Dt) if M_fac is None \
            else kernels.chol_solve_mat_fac(M_fac, Dt)              # (B,nv,R)
        a_diag = (Dt * X).sum(-2)                                  # (B, R)
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
    A = torch.matmul(MD, Dt) if Minv is not None \
        else torch.matmul(D_all, X)                                # (B, R, R)
    gate = (live & (a_diag > 1e-12)).to(dtype)
    r0 = torch.matmul(D_all, res.qacc[..., None])[..., 0] - b_all
    return NoslipProblem(A=A, a_safe=a_safe, lo=lo, hi=hi, gate=gate, r0=r0,
                         u0=u0, X=X, ssum=ssum, Minv=Minv,
                         D_all=None if Minv is None else D_all)


def noslip(M: torch.Tensor, rows: Rows, res: SolveResult, n_fric_dof: int,
           ncmax: int, iterations: int, M_fac: torch.Tensor | None = None,
           tol: float = NOSLIP_TOL) -> SolveResult:
    """Noslip post-pass: Gauss-Seidel over the friction rows only, without
    regularization — dof friction-loss rows box-clamped to
    +-frictionloss, and per contact facet pair the difference updated
    with the sum (the normal force) held fixed (`noslip_problem`).
    float64 runs all `iterations` sweeps whatever `tol` says."""
    B, nefc = rows.aref.shape
    con_base = nefc - ncmax * 6
    pr = noslip_problem(M, rows, res, n_fric_dof, ncmax, M_fac)
    if pr.Minv is not None:
        u = kernels.noslip_sweep(*pr[:7], iterations, 0.0)
        Dtdu = torch.matmul(pr.D_all.transpose(-1, -2),
                            (u - pr.u0)[..., None])
        qacc = res.qacc + torch.matmul(pr.Minv, Dtdu)[..., 0]
    else:
        u = kernels.noslip_sweep(*pr[:7], iterations, tol)
        qacc = res.qacc + torch.matmul(pr.X, (u - pr.u0)[..., None])[..., 0]

    f_dof = u[:, :n_fric_dof]
    ud = u[:, n_fric_dof:]
    fp = 0.5 * (pr.ssum + ud)
    fm = 0.5 * (pr.ssum - ud)
    inter = torch.stack([fp, fm], dim=-1).reshape(B, ncmax * 6)
    efc = torch.cat([f_dof, res.efc_force[:, n_fric_dof:con_base], inter],
                    dim=1)
    jar = j_matvec(rows, qacc) - rows.aref
    return SolveResult(qacc=qacc, efc_force=efc, jar=jar)
