"""The solver's kernels as plain PyTorch, frozen from the port's
`physics/kernels.py`: the plain versions and the front ends that the
solver and the pipeline call, with every CUDA launch taken out.  Any
device, float32 or float64.
"""
from __future__ import annotations

import torch

# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path; the card's yardstick)
# ---------------------------------------------------------------------------

def chol_lower_plain(H: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor as jnp.linalg.cholesky computes it: input
    symmetrized, and NaN on and below the diagonal where the matrix is
    not positive definite (cholesky_ex reports instead of raising)."""
    Hs = 0.5 * (H + H.transpose(-1, -2))
    L, info = torch.linalg.cholesky_ex(Hs)
    n = H.shape[-1]
    tril = torch.ones(n, n, dtype=torch.bool, device=H.device).tril()
    return L.masked_fill((info != 0)[..., None, None] & tril, float("nan"))


def chol_solve_plain(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    L = chol_lower_plain(H)
    return torch.cholesky_solve(g[..., None], L)[..., 0]


def chol_factor_plain(H: torch.Tensor) -> torch.Tensor:
    return chol_lower_plain(H).transpose(-1, -2)


def chol_solve_fac_plain(fac: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    return torch.cholesky_solve(G, fac.transpose(-1, -2))


def chol_solve_mat_plain(H: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    return torch.cholesky_solve(G, chol_lower_plain(H))


def linesearch_plain(jar, Jp, D, floss, active, c1, c2,
                     bracket_iters: int = 12, ls_iters: int = 16):
    """`_linesearch_ref` over the env axis: rows (B, R), c1/c2 (B,);
    returns alpha (B,)."""
    active = active.bool()
    is_fric = floss > 0
    actf = active.to(jar.dtype)
    zero = torch.zeros_like(jar)

    def dphi(alpha):
        jar_a = jar + alpha[:, None] * Jp
        f_quad = -D * jar_a
        f_fric = torch.minimum(torch.maximum(f_quad, -floss), floss)
        f_one = torch.where(jar_a < 0, f_quad, zero)
        f = torch.where(is_fric, f_fric, f_one) * actf
        return c1 + alpha * c2 - (f * Jp).sum(-1)

    def ddphi(alpha):
        jar_a = jar + alpha[:, None] * Jp
        f_quad = -D * jar_a
        quad = torch.where(is_fric, f_quad.abs() <= floss, jar_a < 0) & active
        return c2 + (torch.where(quad, D, zero) * Jp * Jp).sum(-1)

    hi = torch.ones_like(c1)
    for _ in range(bracket_iters):
        hi = torch.where(dphi(hi) < 0, hi * 2.0, hi)
    lo = torch.zeros_like(c1)
    alpha = torch.clamp(hi, max=1.0)
    for _ in range(ls_iters):
        d1 = dphi(alpha)
        d2 = ddphi(alpha)
        neg = d1 < 0
        lo = torch.where(neg, alpha, lo)
        hi = torch.where(neg, hi, alpha)
        a_newton = alpha - d1 / torch.clamp(d2, min=1e-30)
        inside = (a_newton > lo) & (a_newton < hi)
        alpha = torch.where(inside, a_newton, 0.5 * (lo + hi))
    return alpha


def linesearch_cost_plain(jar, Jp, D, floss, active, c1, c2,
                          bracket_iters: int = 12, ls_iters: int = 16):
    """`_linesearch_cost_ref` over the env axis: (alpha, cost), each (B,)."""
    alpha = linesearch_plain(jar, Jp, D, floss, active, c1, c2,
                             bracket_iters, ls_iters)
    actf = active.bool().to(jar.dtype)
    cost = (rows_cost_at(jar, Jp, D, floss, alpha) * actf).sum(-1)
    return alpha, cost


def rows_cost_at(jar, Jp, D, floss, alpha):
    """Per-row constraint cost at jar + alpha Jp; alpha (B,)."""
    return row_cost(jar + alpha[:, None] * Jp, D, floss)


def row_cost(jar_a, D, floss):
    """Per-row constraint cost at jar_a (solver._cost_rows before the
    active mask and the sum)."""
    is_fric = floss > 0
    quad_cost = 0.5 * D * jar_a * jar_a
    lin_cost = floss * jar_a.abs() \
        - 0.5 * floss ** 2 / torch.clamp(D, min=1e-30)
    fric_cost = torch.where((D * jar_a).abs() <= floss, quad_cost, lin_cost)
    one_cost = torch.where(jar_a < 0, quad_cost, torch.zeros_like(jar_a))
    return torch.where(is_fric, fric_cost, one_cost)


def noslip_sweep_plain(A, a_safe, lo, hi, gate, r0, u0,
                       iters: int) -> torch.Tensor:
    """`_noslip_scan` over the env axis: fixed `iters` sweeps of R
    sequential row updates (the JAX CPU path never exits early)."""
    r = r0.clone()
    u = u0.clone()
    for _ in range(iters):
        for k in range(r.shape[-1]):
            uk = u[:, k]
            du = -r[:, k] / a_safe[:, k]
            u_new = torch.minimum(torch.maximum(uk + du, lo[:, k]), hi[:, k])
            du_act = torch.where(gate[:, k] > 0, u_new - uk,
                                 torch.zeros_like(uk))
            r = r + A[:, :, k] * du_act[:, None]
            u[:, k] = uk + du_act
    return u


# ---------------------------------------------------------------------------
# Front ends (what the solver and pipeline call)
# ---------------------------------------------------------------------------

def chol_solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x = H^-1 g for SPD H (B, nv, nv), g (B, nv); NaN where H is not PD."""
    return chol_solve_plain(H, g)


def chol_solve_factor(H: torch.Tensor, g: torch.Tensor):
    """(x, fac): the solve plus a reusable factor of H (noslip reuses the
    mass-matrix factor computed for qacc_smooth)."""
    L = chol_lower_plain(H)
    return torch.cholesky_solve(g[..., None], L)[..., 0], L.transpose(-1, -2)


def chol_solve_mat_fac(fac: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """X = H^-1 G (B, nv, R) from a `chol_solve_factor` factor."""
    return chol_solve_fac_plain(fac, G)


def chol_solve_mat(H: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """X = H^-1 G (B, nv, R) for SPD H (B, nv, nv): factor and solve."""
    return chol_solve_mat_plain(H, G)


def linesearch(jar, Jp, D, floss, active, c1, c2,
               bracket_iters: int = 12, ls_iters: int = 16):
    """The exact Newton linesearch's alpha, per env."""
    return linesearch_plain(jar, Jp, D, floss, active, c1, c2,
                            bracket_iters, ls_iters)


def linesearch_cost(jar, Jp, D, floss, active, c1, c2,
                    bracket_iters: int = 12, ls_iters: int = 16):
    """(alpha, summed active row cost at alpha), per env."""
    return linesearch_cost_plain(jar, Jp, D, floss, active, c1, c2,
                                 bracket_iters, ls_iters)


def noslip_sweep(A, a_safe, lo, hi, gate, r0, u0, iters: int,
                 tol: float = 0.0) -> torch.Tensor:
    """Noslip Gauss-Seidel sweeps.  On the card tol > 0 stops an env once
    a sweep's largest update is below tol * max(max(hi), 1); the plain
    version always runs `iters` sweeps, as the JAX CPU path does."""
    return noslip_sweep_plain(A, a_safe, lo, hi, gate, r0, u0, iters)
