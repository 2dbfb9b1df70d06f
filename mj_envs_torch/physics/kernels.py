"""Solver kernels of the PyTorch port and their plain PyTorch versions
(`mj_envs_tpu/physics/kernels.py`).

Seven entry points carry the solver's hot loops on the card, hand-written
in CUDA (`mj_envs_torch/csrc/`, built by `_build.py`):

* ``chol_factor``        — batched Cholesky factor (TPU `_chol_factor_kernel`)
* ``chol_solve_fac``     — substitution from a factor, R right-hand sides
                           (TPU `_chol_solve_mat_fac_kernel`)
* ``chol_factor_solve``  — factor + solve, one right-hand side
                           (TPU `_chol_solve_kernel`)
* ``chol_solve_mat``     — factor + solve, R right-hand sides, the factor
                           never leaving shared memory
                           (TPU `_chol_solve_mat_kernel`)
* ``linesearch_cost``    — exact Newton linesearch + row cost at alpha
                           (TPU `_linesearch_cost_kernel`)
* ``linesearch``         — the same search, alpha only
                           (TPU `_linesearch_kernel`)
* ``noslip_sweep``       — projected Gauss-Seidel noslip sweeps
                           (TPU `_noslip_kernel`)

The eighth kernel, the fused forward kinematics (``fk``, TPU
`_fk_kernel`), has its wrapper in `kinematics.py` and is counted here,
as are the narrowphase's pair types but the sphere ones (``narrow_*``,
no TPU kernel: `csrc/narrow_cyl.cu` the four cylinder types,
`csrc/narrow_plain.cu` the five others), whose wrapper is in
`collision/narrow_cuda.py`.

Two more CUDA kernels are references, not ports: ``linesearch_seq_cuda``
(the sequential search that ``linesearch`` and ``linesearch_cost`` equal
bit for bit) and ``chol_solve_mat_block_cuda`` (the block factor-and-solve
that the Cholesky kernels equal bit for bit).  Only the bit-for-bit
checks call them; they are not in `KERNELS` and no front end reaches
them.

Dispatch mirrors the JAX package's `custom_vmap` rule (`use_pallas =
dtype == float32 and backend == "tpu"`): a CUDA float32 tensor launches
the kernel, a CPU tensor takes the plain version beside it.  A float64
tensor takes the plain version on any device, the card included, and
launches no kernel: the JAX package dispatches its kernels for float32
only, and its float64 oracle-parity path never reaches one.  Any other
dtype on the card (float16, bfloat16) raises.  Each launch adds one to
`launches[name]`; `launches` is the tracer's registry
(`mj_envs_torch.trace.counters`), whose other keys hold a dot.

The factor layout is the JAX package's on every backend: fac[b, k, :] is
column k of L (so fac is L^T, zero below the diagonal).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import trace

KERNELS = ("fk", "chol_factor", "chol_solve_fac", "chol_factor_solve",
           "linesearch_cost", "noslip_sweep", "linesearch", "chol_solve_mat",
           "narrow_plane_cylinder", "narrow_capsule_cylinder",
           "narrow_cylinder_cylinder", "narrow_cylinder_box",
           "narrow_plane_capsule", "narrow_plane_box",
           "narrow_capsule_capsule", "narrow_capsule_box", "narrow_box_box")
launches: Dict[str, int] = trace.counters
launches.update((k, 0) for k in KERNELS)
CHOL_SOLVE_MAX_NV = 64   # chol.cu's kMaxSolveNv: two columns per lane
CHOL_SUBST_MAX_NV = 64   # chol.cu's kMaxSubstNv: the largest nv bucket
NOSLIP_MAX_R = 256       # noslip.cu's kMaxR: 8 rows a lane


def reset_launches() -> None:
    """Every count of the registry back to 0: the launches and the
    tracer's counters beside them."""
    for k in launches:
        launches[k] = 0


_MASKS = (torch.bool, torch.uint8)   # linesearch's `active` rows


def _on_card(*ts: torch.Tensor) -> bool:
    """True: launch the CUDA kernel; False: run the plain version (on
    the CPU, and for float64 on any device)."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("kernel inputs lie on different devices: "
                         f"{[str(t.device) for t in ts]}")
    if dev.type == "cpu":
        return False
    floats = [t for t in ts if t.dtype not in _MASKS]
    if dev.type == "cuda":
        if all(t.dtype == torch.float32 for t in floats):
            return True
        if all(t.dtype == torch.float64 for t in floats):
            return False
    raise TypeError("the CUDA kernels take float32 tensors on a CUDA "
                    "device (float64 runs the plain versions); got "
                    f"{[t.dtype for t in ts]} on {dev}")


def _check(name: str, t: torch.Tensor, shape, dtype=torch.float32) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_if(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


# ---------------------------------------------------------------------------
# CUDA launches (float32, contiguous, batch-first)
# ---------------------------------------------------------------------------

def chol_factor_cuda(H: torch.Tensor) -> torch.Tensor:
    """K2: fac (B, nv, nv) of H (B, nv, nv), one warp per env (K4's
    factor); nv <= CHOL_SOLVE_MAX_NV."""
    from ._build import load
    B, nv = H.shape[0], H.shape[-1]
    if nv > CHOL_SOLVE_MAX_NV:
        raise ValueError(f"the chol_factor kernel takes nv <= "
                         f"{CHOL_SOLVE_MAX_NV}; got {nv}")
    _check("H", H, (B, nv, nv))
    fac = torch.empty_like(H)
    err = load().chol_factor(H.data_ptr(), fac.data_ptr(), B, nv,
                             _stream(H))
    _raise_if(err, "chol_factor")
    launches["chol_factor"] += 1
    return fac


def chol_solve_fac_cuda(fac: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """K3: X (B, nv, R) = (L L^T)^-1 G from fac; a thread per right-hand
    side in registers (a warp per env at R = 1); nv <= CHOL_SUBST_MAX_NV."""
    from ._build import load
    B, nv, R = G.shape
    if nv > CHOL_SUBST_MAX_NV:
        raise ValueError(f"the chol_solve_fac kernel takes nv <= "
                         f"{CHOL_SUBST_MAX_NV}; got {nv}")
    _check("fac", fac, (B, nv, nv))
    _check("G", G, (B, nv, R))
    X = torch.empty_like(G)
    err = load().chol_solve_fac(fac.data_ptr(), G.data_ptr(), X.data_ptr(),
                                B, nv, R, _stream(G))
    _raise_if(err, "chol_solve_fac")
    launches["chol_solve_fac"] += 1
    return X


def chol_factor_solve_cuda(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K4: x (B, nv) = H^-1 g, one warp per env, the factor kept in
    shared memory; nv <= CHOL_SOLVE_MAX_NV."""
    from ._build import load
    B, nv = g.shape
    if nv > CHOL_SOLVE_MAX_NV:
        raise ValueError(f"the chol_factor_solve kernel takes nv <= "
                         f"{CHOL_SOLVE_MAX_NV}; got {nv}")
    _check("H", H, (B, nv, nv))
    _check("g", g, (B, nv))
    x = torch.empty_like(g)
    err = load().chol_factor_solve(H.data_ptr(), g.data_ptr(), x.data_ptr(),
                                   B, nv, _stream(H))
    _raise_if(err, "chol_factor_solve")
    launches["chol_factor_solve"] += 1
    return x


def _chol_solve_mat(entry: str, H: torch.Tensor,
                    G: torch.Tensor) -> torch.Tensor:
    from ._build import load
    B, nv, R = G.shape
    _check("H", H, (B, nv, nv))
    _check("G", G, (B, nv, R))
    X = torch.empty_like(G)
    err = getattr(load(), entry)(H.data_ptr(), G.data_ptr(), X.data_ptr(),
                                 B, nv, R, _stream(G))
    _raise_if(err, entry)
    return X


def chol_solve_mat_cuda(H: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """K8: X (B, nv, R) = H^-1 G, factor and solve in one launch: K2's
    warp factor, then K3's substitution (K4 at R = 1);
    nv <= CHOL_SOLVE_MAX_NV."""
    nv = G.shape[1]
    if nv > CHOL_SOLVE_MAX_NV:
        raise ValueError(f"the chol_solve_mat kernel takes nv <= "
                         f"{CHOL_SOLVE_MAX_NV}; got {nv}")
    X = _chol_solve_mat("chol_solve_mat", H, G)
    launches["chol_solve_mat"] += 1
    return X


def chol_solve_mat_block_cuda(H: torch.Tensor,
                              G: torch.Tensor) -> torch.Tensor:
    """The reference for the bit-for-bit checks: X (B, nv, R) = H^-1 G by
    the block factor and substitution, one block of threads per env (K8
    before its redesign).  Not counted, and reached from no front end."""
    return _chol_solve_mat("chol_solve_mat_block", H, G)


def _check_linesearch(jar, Jp, D, floss, active, c1, c2):
    B, R = jar.shape
    for name, t in (("jar", jar), ("Jp", Jp), ("D", D), ("floss", floss)):
        _check(name, t, (B, R))
    if active.dtype not in _MASKS:
        raise TypeError(f"active: expected bool or uint8, got {active.dtype}")
    _check("active", active, (B, R), active.dtype)
    _check("c1", c1, (B,))
    _check("c2", c2, (B,))
    return B, R


def linesearch_cost_cuda(jar, Jp, D, floss, active, c1, c2,
                         bracket_iters: int = 12, ls_iters: int = 16,
                         steps: torch.Tensor | None = None):
    """K5: (alpha (B,), cost (B,)).  `steps`, an int32 (B,) tensor,
    receives the Newton steps each env ran (the search stops at a step
    that changes nothing)."""
    from ._build import load
    B, R = _check_linesearch(jar, Jp, D, floss, active, c1, c2)
    if steps is not None:
        _check("steps", steps, (B,), torch.int32)
    alpha = torch.empty_like(c1)
    cost = torch.empty_like(c1)
    err = load().linesearch_cost(
        jar.data_ptr(), Jp.data_ptr(), D.data_ptr(), floss.data_ptr(),
        active.data_ptr(), c1.data_ptr(), c2.data_ptr(), alpha.data_ptr(),
        cost.data_ptr(), None if steps is None else steps.data_ptr(),
        B, R, bracket_iters, ls_iters, _stream(jar))
    _raise_if(err, "linesearch_cost")
    launches["linesearch_cost"] += 1
    return alpha, cost


def _linesearch_alpha(entry: str, jar, Jp, D, floss, active, c1, c2,
                      bracket_iters: int, ls_iters: int) -> torch.Tensor:
    from ._build import load
    B, R = _check_linesearch(jar, Jp, D, floss, active, c1, c2)
    alpha = torch.empty_like(c1)
    err = getattr(load(), entry)(
        jar.data_ptr(), Jp.data_ptr(), D.data_ptr(), floss.data_ptr(),
        active.data_ptr(), c1.data_ptr(), c2.data_ptr(), alpha.data_ptr(),
        B, R, bracket_iters, ls_iters, _stream(jar))
    _raise_if(err, entry)
    return alpha


def linesearch_cuda(jar, Jp, D, floss, active, c1, c2,
                    bracket_iters: int = 12, ls_iters: int = 16):
    """K7: alpha (B,), K5's fused search without its cost pass."""
    alpha = _linesearch_alpha("linesearch", jar, Jp, D, floss, active, c1,
                              c2, bracket_iters, ls_iters)
    launches["linesearch"] += 1
    return alpha


def linesearch_seq_cuda(jar, Jp, D, floss, active, c1, c2,
                        bracket_iters: int = 12, ls_iters: int = 16):
    """The reference for the bit-for-bit checks: alpha (B,) by the
    sequential search, one warp reduction per evaluation (K7 before its
    redesign).  Not counted, and reached from no front end."""
    return _linesearch_alpha("linesearch_seq", jar, Jp, D, floss, active,
                             c1, c2, bracket_iters, ls_iters)


def noslip_sweep_cuda(A, a_safe, lo, hi, gate, r0, u0, iters: int,
                      tol: float = 0.0,
                      sweeps: torch.Tensor | None = None) -> torch.Tensor:
    """K6: u (B, R) after at most `iters` sweeps (per-env exit if tol>0),
    one warp per env; R <= NOSLIP_MAX_R.  `sweeps`, an int32 (B,)
    tensor, receives the sweeps each env ran."""
    from ._build import load
    B, R = r0.shape
    if R > NOSLIP_MAX_R:
        raise ValueError(f"the noslip_sweep kernel takes R <= "
                         f"{NOSLIP_MAX_R}; got {R}")
    _check("A", A, (B, R, R))
    for name, t in (("a_safe", a_safe), ("lo", lo), ("hi", hi),
                    ("gate", gate), ("r0", r0), ("u0", u0)):
        _check(name, t, (B, R))
    if sweeps is not None:
        _check("sweeps", sweeps, (B,), torch.int32)
    u = torch.empty_like(u0)
    err = load().noslip_sweep(
        A.data_ptr(), a_safe.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        gate.data_ptr(), r0.data_ptr(), u0.data_ptr(), u.data_ptr(),
        None if sweeps is None else sweeps.data_ptr(),
        B, R, iters, float(tol), _stream(A))
    _raise_if(err, "noslip_sweep")
    launches["noslip_sweep"] += 1
    return u


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
    if _on_card(H, g):
        return chol_factor_solve_cuda(H.contiguous(), g.contiguous())
    return chol_solve_plain(H, g)


def chol_solve_factor(H: torch.Tensor, g: torch.Tensor):
    """(x, fac): the solve plus a reusable factor of H (noslip reuses the
    mass-matrix factor computed for qacc_smooth)."""
    if _on_card(H, g):
        fac = chol_factor_cuda(H.contiguous())
        x = chol_solve_fac_cuda(fac, g.contiguous()[..., None])[..., 0]
        return x, fac
    L = chol_lower_plain(H)
    return torch.cholesky_solve(g[..., None], L)[..., 0], L.transpose(-1, -2)


def chol_solve_mat_fac(fac: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """X = H^-1 G (B, nv, R) from a `chol_solve_factor` factor."""
    if _on_card(fac, G):
        return chol_solve_fac_cuda(fac.contiguous(), G.contiguous())
    return chol_solve_fac_plain(fac, G)


def chol_solve_mat(H: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """X = H^-1 G (B, nv, R) for SPD H (B, nv, nv): factor and solve."""
    if _on_card(H, G):
        return chol_solve_mat_cuda(H.contiguous(), G.contiguous())
    return chol_solve_mat_plain(H, G)


def linesearch(jar, Jp, D, floss, active, c1, c2,
               bracket_iters: int = 12, ls_iters: int = 16):
    """The exact Newton linesearch's alpha, per env."""
    if _on_card(jar, Jp, D, floss, active, c1, c2):
        return linesearch_cuda(
            *(t.contiguous() for t in (jar, Jp, D, floss, active, c1, c2)),
            bracket_iters, ls_iters)
    return linesearch_plain(jar, Jp, D, floss, active, c1, c2,
                            bracket_iters, ls_iters)


def linesearch_cost(jar, Jp, D, floss, active, c1, c2,
                    bracket_iters: int = 12, ls_iters: int = 16):
    """(alpha, summed active row cost at alpha), per env."""
    if _on_card(jar, Jp, D, floss, active, c1, c2):
        return linesearch_cost_cuda(
            *(t.contiguous() for t in (jar, Jp, D, floss, active, c1, c2)),
            bracket_iters, ls_iters)
    return linesearch_cost_plain(jar, Jp, D, floss, active, c1, c2,
                                 bracket_iters, ls_iters)


def noslip_sweep(A, a_safe, lo, hi, gate, r0, u0, iters: int,
                 tol: float = 0.0) -> torch.Tensor:
    """Noslip Gauss-Seidel sweeps.  On the card tol > 0 stops an env once
    a sweep's largest update is below tol * max(max(hi), 1); the plain
    version always runs `iters` sweeps, as the JAX CPU path does."""
    if _on_card(A, a_safe, lo, hi, gate, r0, u0):
        return noslip_sweep_cuda(
            *(t.contiguous() for t in (A, a_safe, lo, hi, gate, r0, u0)),
            iters, tol)
    return noslip_sweep_plain(A, a_safe, lo, hi, gate, r0, u0, iters)


# ---------------------------------------------------------------------------
# Probe-problem generators (numpy, seeded): the distributions of the JAX
# package's random_noslip_problem / random_linesearch_problem.
# ---------------------------------------------------------------------------

def random_spd_problem(rng: np.random.Generator, B: int, nv: int, R: int,
                       dtype=np.float32):
    """(H, g, G): SPD H = G0 G0^T / nv + nv I, one and R right-hand sides."""
    G0 = rng.standard_normal((B, nv, nv))
    H = np.einsum("bik,bjk->bij", G0, G0) / nv + nv * np.eye(nv)
    g = rng.standard_normal((B, nv))
    G = rng.standard_normal((B, nv, R))
    return H.astype(dtype), g.astype(dtype), G.astype(dtype)


def random_noslip_problem(rng: np.random.Generator, B: int, R: int,
                          dtype=np.float32, empty: int = 0):
    """(A, a_safe, lo, hi, gate, r0, u0): SPD-ish A with a dominant
    diagonal (like D M^-1 D^T), box bounds, ~75% live rows.  The last
    `empty` rows are empty contact slots, as in a real chunk: their D row
    is zero, so their row and column of A, r0, u0, lo, hi and gate are
    0 and a_safe is 1 (the same draws: empty = 0 gives the same arrays)."""
    G = rng.standard_normal((B, R, R)).astype(dtype)
    A = np.einsum("bik,bjk->bij", G, G) / R + 2.0 * np.eye(R, dtype=dtype)
    a_safe = np.maximum(np.einsum("bii->bi", A), 1e-3)
    lo = -rng.uniform(0.1, 2.0, (B, R))
    hi = rng.uniform(0.1, 2.0, (B, R))
    gate = (rng.uniform(size=(B, R)) > 0.25).astype(dtype)
    r0 = rng.standard_normal((B, R))
    u0 = np.clip(rng.standard_normal((B, R)) * 0.1, lo, hi)
    if empty:
        e = slice(R - empty, R)
        A[:, e, :] = 0.0
        A[:, :, e] = 0.0
        a_safe[:, e] = 1.0
        for x in (lo, hi, gate, r0, u0):
            x[:, e] = 0.0
    return tuple(np.asarray(x, dtype=dtype)
                 for x in (A, a_safe, lo, hi, gate, r0, u0))


def random_linesearch_problem(rng: np.random.Generator, B: int, R: int,
                              dtype=np.float32):
    """(jar, Jp, D, floss, active, c1, c2) with a descent direction
    (c1 < 0) and ~30% friction-loss rows."""
    jar = rng.standard_normal((B, R)).astype(dtype)
    Jp = rng.standard_normal((B, R)).astype(dtype)
    D = rng.uniform(0.1, 10.0, (B, R)).astype(dtype)
    floss = np.where(rng.uniform(size=(B, R)) > 0.7,
                     rng.uniform(0.1, 3.0, (B, R)), 0.0).astype(dtype)
    active = rng.uniform(size=(B, R)) > 0.2
    c1 = -rng.uniform(0.1, 5.0, B).astype(dtype)
    c2 = rng.uniform(0.5, 5.0, B).astype(dtype)
    return jar, Jp, D, floss, active, c1, c2
