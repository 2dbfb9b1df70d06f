"""Kernel front ends of the PyTorch port against the JAX package.

Each test makes its inputs with a seeded numpy generator
(`mj_envs_torch.physics.kernels.random_*_problem`) and feeds the same
arrays to the JAX function and to the port.  On the CPU the port's
front ends run their plain PyTorch versions; the JAX side runs as its
own CPU path does (vmapped references), and its Pallas kernels in
interpret mode, as `tests/test_kernels.py` runs them.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mj_envs_tpu.physics import kernels as KR
from mj_envs_torch.physics import kernels as TK


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # xdist runs six workers on the CPU: keep torch from oversubscribing.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret():
    KR._INTERPRET = True
    try:
        yield
    finally:
        KR._INTERPRET = False


def _t(*xs):
    return [torch.as_tensor(np.asarray(x)) for x in xs]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# Cholesky family (K2 chol_factor, K3 chol_solve_fac, K4 chol_factor_solve)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R", [1, 129])
def test_cholesky_family_matches_jax(R):
    """chol_solve, chol_solve_factor and chol_solve_mat_fac against the
    JAX front ends under vmap on the CPU (B = 8, nv = 33)."""
    H, g, G = TK.random_spd_problem(np.random.default_rng(0), 8, 33, R)
    x_j = jax.vmap(KR.chol_solve)(H, g)
    xf_j, fac_j = jax.vmap(KR.chol_solve_factor)(H, g)
    X_j = jax.vmap(KR.chol_solve_mat_fac)(fac_j, G)

    Ht, gt, Gt = _t(H, g, G)
    x_t = TK.chol_solve(Ht, gt)
    xf_t, fac_t = TK.chol_solve_factor(Ht, gt)
    X_t = TK.chol_solve_mat_fac(fac_t, Gt)

    tol = dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(_np(x_t), _np(x_j), **tol)
    np.testing.assert_allclose(_np(xf_t), _np(xf_j), **tol)
    np.testing.assert_allclose(_np(fac_t), _np(fac_j), **tol)
    np.testing.assert_allclose(_np(X_t), _np(X_j), **tol)
    # fac[b, k, :] is column k of L: zero below the diagonal.
    assert np.all(np.tril(_np(fac_t), -1) == 0.0)


def test_cholesky_family_matches_pallas_interpret(interpret):
    """The port's front ends against the TPU kernels themselves
    (chol_factor_bm, _chol_solve_mat_fac_pallas, _chol_solve_pallas) in
    interpret mode at (B = 3, nv = 6, R = 5)."""
    H, g, G = TK.random_spd_problem(np.random.default_rng(1), 3, 6, 5)
    Lt_bm = KR.chol_factor_bm(jnp.asarray(H))
    fac_p = np.moveaxis(np.asarray(Lt_bm), -1, 0)[:3]
    X_p = KR._chol_solve_mat_fac_pallas(Lt_bm, jnp.asarray(G))
    x_p = KR._chol_solve_pallas(jnp.asarray(H), jnp.asarray(g))

    Ht, gt, Gt = _t(H, g, G)
    _, fac_t = TK.chol_solve_factor(Ht, gt)
    tol = dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(_np(fac_t), fac_p, **tol)
    np.testing.assert_allclose(_np(TK.chol_solve_mat_fac(fac_t, Gt)),
                               _np(X_p), **tol)
    np.testing.assert_allclose(_np(TK.chol_solve(Ht, gt)), _np(x_p), **tol)


def test_cholesky_not_positive_definite_gives_nan():
    """A failed factorization yields NaN (never an exception), as
    jnp.linalg.cholesky does: newton_solve's gradient fallback keys on
    it.  Other envs of the batch are unaffected."""
    H, g, G = TK.random_spd_problem(np.random.default_rng(2), 4, 33, 3)
    H[1] = -H[1]
    x_j = jax.vmap(KR.chol_solve)(H, g)
    xf_j, fac_j = jax.vmap(KR.chol_solve_factor)(H, g)
    X_j = jax.vmap(KR.chol_solve_mat_fac)(fac_j, G)
    assert np.all(np.isnan(np.asarray(x_j)[1]))

    Ht, gt, Gt = _t(H, g, G)
    x_t = TK.chol_solve(Ht, gt)
    xf_t, fac_t = TK.chol_solve_factor(Ht, gt)
    X_t = TK.chol_solve_mat_fac(fac_t, Gt)
    # NaN where JAX has NaN (assert_allclose matches NaN positions).
    for a, b in ((x_t, x_j), (xf_t, xf_j), (fac_t, fac_j), (X_t, X_j)):
        a, b = _np(a), _np(b)
        assert np.all(np.isfinite(np.delete(a, 1, axis=0)))
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# Linesearch (K5 linesearch_cost)
# ---------------------------------------------------------------------------

def test_linesearch_cost_matches_vmapped_ref():
    args = TK.random_linesearch_problem(np.random.default_rng(3), 8, 296)
    a_j, c_j = jax.vmap(
        lambda *xs: KR._linesearch_cost_ref(*xs, 12, 16))(*args)
    a_t, c_t = TK.linesearch_cost(*_t(*args), 12, 16)
    np.testing.assert_allclose(_np(a_t), _np(a_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(c_t), _np(c_j), rtol=1e-5, atol=1e-6)


def test_linesearch_cost_takes_uint8_active():
    """`active` may come as bool or uint8 rows; both give one answer."""
    jar, Jp, D, fl, act, c1, c2 = _t(
        *TK.random_linesearch_problem(np.random.default_rng(9), 4, 40))
    want = TK.linesearch_cost(jar, Jp, D, fl, act, c1, c2)
    got = TK.linesearch_cost(jar, Jp, D, fl, act.to(torch.uint8), c1, c2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_linesearch_cost_matches_pallas_interpret(interpret):
    args = TK.random_linesearch_problem(np.random.default_rng(4), 5, 16)
    a_p, c_p = KR._linesearch_cost_pallas(*[jnp.asarray(x) for x in args],
                                          12, 16)
    a_t, c_t = TK.linesearch_cost(*_t(*args), 12, 16)
    np.testing.assert_allclose(_np(a_t), _np(a_p), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(c_t), _np(c_p), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Linesearch, alpha only (K7 linesearch)
# ---------------------------------------------------------------------------

def test_linesearch_matches_vmapped_ref():
    args = TK.random_linesearch_problem(np.random.default_rng(14), 8, 296)
    a_j = jax.vmap(lambda *xs: KR._linesearch_ref(*xs, 12, 16))(*args)
    a_t = TK.linesearch(*_t(*args), 12, 16)
    np.testing.assert_allclose(_np(a_t), _np(a_j), rtol=1e-5, atol=1e-6)
    # The fused form's alpha is the same search.
    a_c, _ = TK.linesearch_cost(*_t(*args), 12, 16)
    assert torch.equal(a_t, a_c)


def test_linesearch_matches_pallas_interpret(interpret):
    args = TK.random_linesearch_problem(np.random.default_rng(15), 5, 16)
    a_p = KR._linesearch_pallas(*[jnp.asarray(x) for x in args], 12, 16)
    a_t = TK.linesearch(*_t(*args), 12, 16)
    np.testing.assert_allclose(_np(a_t), _np(a_p), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Factor and solve over R right-hand sides (K8 chol_solve_mat)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,nv,R", [(3, 6, 5), (4, 33, 129)])
def test_chol_solve_mat_matches_pallas_interpret(interpret, B, nv, R):
    """The port's chol_solve_mat against the TPU kernel itself
    (_chol_solve_mat_pallas in interpret mode), at a toy shape and at
    hammer's noslip shape (nv = 33, R = 129)."""
    H, _, G = TK.random_spd_problem(np.random.default_rng(16), B, nv, R)
    X_p = KR._chol_solve_mat_pallas(jnp.asarray(H), jnp.asarray(G))
    X_t = TK.chol_solve_mat(*_t(H, G))
    np.testing.assert_allclose(_np(X_t), _np(X_p), rtol=2e-4, atol=2e-5)


def test_chol_solve_mat_matches_vmapped_front_end():
    H, _, G = TK.random_spd_problem(np.random.default_rng(17), 8, 33, 129)
    X_j = jax.vmap(KR.chol_solve_mat)(H, G)
    X_t = TK.chol_solve_mat(*_t(H, G))
    np.testing.assert_allclose(_np(X_t), _np(X_j), rtol=2e-4, atol=2e-5)


def test_noslip_without_factor_matches_factored():
    """`solver.noslip(M_fac=None)` factors M itself (chol_solve_mat);
    on the same rows it gives what the reused factor gives."""
    from mj_envs_torch import envs
    from mj_envs_torch.envs.base import _apply_var
    from mj_envs_torch.parallel.vector import VectorEnv, random_actions
    from mj_envs_torch.physics import pipeline as P
    from mj_envs_torch.physics import solver as S
    env = envs.make("hammer-v0", device="cpu")
    venv = VectorEnv(env, 4)
    st = venv.reset(seed=5)
    gen = torch.Generator().manual_seed(5)
    for _ in range(3):
        st = venv.step(st, random_actions(gen, 4, env.nu, "cpu"))
    m, d, s = _apply_var(env.model, st.var), st.data, env.spec
    out = P.forward_core(m, d.qpos, d.qvel, d.ctrl, d.qacc_warmstart,
                         d.qfrc_applied)
    _, fac = TK.chol_solve_factor(out.M, out.qacc_smooth)
    assert out.rows.active.any()
    nfl, nc = int(np.sum(s.dof_hasfrictionloss)), P.ncmax(s)
    res = S.newton_solve(out.M, out.qacc_smooth, out.rows, d.qacc_warmstart,
                         iterations=s.iterations)
    with_fac = S.noslip(out.M, out.rows, res, nfl, nc, s.noslip_iterations,
                        M_fac=fac)
    no_fac = S.noslip(out.M, out.rows, res, nfl, nc, s.noslip_iterations)
    for f in ("qacc", "efc_force", "jar"):
        np.testing.assert_allclose(_np(getattr(no_fac, f)),
                                   _np(getattr(with_fac, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)


# ---------------------------------------------------------------------------
# Noslip (K6 noslip_sweep)
# ---------------------------------------------------------------------------

def test_noslip_sweep_matches_vmapped_scan():
    """Hammer's noslip width (R = 129) with the JAX default 20 sweeps;
    the plain version ignores tol, as the JAX CPU path does."""
    args = TK.random_noslip_problem(np.random.default_rng(5), 4, 129)
    u_j = jax.vmap(lambda *xs: KR._noslip_scan(*xs, 20))(*args)
    u_t = TK.noslip_sweep(*_t(*args), 20, tol=1e-3)
    np.testing.assert_allclose(_np(u_t), _np(u_j), rtol=1e-5, atol=1e-5)


def test_noslip_sweep_matches_pallas_interpret(interpret):
    args = TK.random_noslip_problem(np.random.default_rng(6), 3, 7)
    u_p = KR._noslip_pallas(*[jnp.asarray(x) for x in args], 4, tol=0.0)
    u_t = TK.noslip_sweep(*_t(*args), 4, tol=0.0)
    np.testing.assert_allclose(_np(u_t), _np(u_p), rtol=1e-5, atol=1e-5)


def test_noslip_sweep_with_empty_rows_matches_vmapped_scan():
    """A real chunk's sweep problem holds empty contact slots (A row and
    column 0, r 0, gate 0, a_safe 1): the plain version keeps the scan's
    result there, every such row staying at u0 = 0 exactly."""
    empty = 64
    args = TK.random_noslip_problem(np.random.default_rng(19), 4, 129,
                                    empty=empty)
    assert not args[0][:, -empty:].any() and not args[4][:, -empty:].any()
    u_j = jax.vmap(lambda *xs: KR._noslip_scan(*xs, 20))(*args)
    u_t = TK.noslip_sweep(*_t(*args), 20, tol=0.0)
    np.testing.assert_allclose(_np(u_t), _np(u_j), rtol=1e-5, atol=1e-5)
    assert np.all(_np(u_t)[:, -empty:] == 0.0)
    assert np.all(_np(u_j)[:, -empty:] == 0.0)


def test_noslip_sweep_with_empty_rows_matches_pallas_interpret(interpret):
    args = TK.random_noslip_problem(np.random.default_rng(20), 3, 9, empty=4)
    u_p = KR._noslip_pallas(*[jnp.asarray(x) for x in args], 4, tol=0.0)
    u_t = TK.noslip_sweep(*_t(*args), 4, tol=0.0)
    np.testing.assert_allclose(_np(u_t), _np(u_p), rtol=1e-5, atol=1e-5)
    assert np.all(_np(u_t)[:, -4:] == 0.0)


# ---------------------------------------------------------------------------
# Dispatch rule and the generators
# ---------------------------------------------------------------------------

def test_dispatch_cpu_plain_other_devices_raise():
    """A CPU tensor takes the plain version (no launch is counted); a
    tensor on any other non-CUDA device raises instead of falling back."""
    TK.reset_launches()
    H, g, _ = TK.random_spd_problem(np.random.default_rng(7), 2, 5, 1)
    Ht, gt = _t(H, g)
    TK.chol_solve(Ht, gt)
    TK.chol_solve_factor(Ht, gt)
    assert all(n == 0 for n in TK.launches.values())
    meta = torch.empty(2, 5, 5, device="meta")
    with pytest.raises(TypeError):
        TK.chol_solve(meta, torch.empty(2, 5, device="meta"))
    with pytest.raises(ValueError):
        TK.chol_solve(Ht, torch.empty(2, 5, device="meta"))


def test_chol_factor_solve_kernel_refuses_nv_above_its_limit():
    """K4 runs one warp per env with two columns per lane: its wrapper
    raises for nv above 64, naming the limit, before any launch; the
    front end's plain version on the CPU has no such limit."""
    H, g, _ = TK.random_spd_problem(np.random.default_rng(7), 2, 65, 1)
    Ht, gt = _t(H, g)
    with pytest.raises(ValueError, match=str(TK.CHOL_SOLVE_MAX_NV)):
        TK.chol_factor_solve_cuda(Ht, gt)
    assert TK.CHOL_SOLVE_MAX_NV == 64
    assert torch.isfinite(TK.chol_solve(Ht, gt)).all()


def test_chol_solve_fac_kernel_refuses_nv_above_its_limit():
    """K3 keeps a right-hand side's nv values in registers, in buckets of
    nv up to 64: its wrapper raises for nv above 64, naming the limit,
    before any launch; the front end's plain version on the CPU has no
    such limit."""
    H, _, G = TK.random_spd_problem(np.random.default_rng(7), 2, 65, 3)
    Ht, Gt = _t(H, G)
    fac = TK.chol_factor_plain(Ht).contiguous()
    n = TK.launches["chol_solve_fac"]
    with pytest.raises(ValueError, match=str(TK.CHOL_SUBST_MAX_NV)):
        TK.chol_solve_fac_cuda(fac, Gt)
    assert TK.launches["chol_solve_fac"] == n
    assert TK.CHOL_SUBST_MAX_NV == 64
    assert torch.isfinite(TK.chol_solve_mat_fac(fac, Gt)).all()


def test_noslip_sweep_kernel_refuses_R_above_its_limit():
    """K6 keeps a lane's rows in registers, in buckets of up to 8 rows a
    lane: its wrapper raises for R above 256, naming the limit, before
    any launch; the front end's plain version on the CPU has no such
    limit."""
    R = TK.NOSLIP_MAX_R + 1
    args = _t(*TK.random_noslip_problem(np.random.default_rng(21), 1, R))
    n = TK.launches["noslip_sweep"]
    with pytest.raises(ValueError, match=str(TK.NOSLIP_MAX_R)):
        TK.noslip_sweep_cuda(*args, 1)
    assert TK.launches["noslip_sweep"] == n
    assert TK.NOSLIP_MAX_R == 256
    assert torch.isfinite(TK.noslip_sweep(*args, 1)).all()


def test_chol_factor_kernel_refuses_nv_above_its_limit():
    """K2 runs K4's warp factor, two columns per lane: its wrapper raises
    for nv above 64, naming the limit, before any launch."""
    H, g, _ = TK.random_spd_problem(np.random.default_rng(7), 2, 65, 1)
    Ht, gt = _t(H, g)
    n = TK.launches["chol_factor"]
    with pytest.raises(ValueError, match=str(TK.CHOL_SOLVE_MAX_NV)):
        TK.chol_factor_cuda(Ht)
    assert TK.launches["chol_factor"] == n
    _, fac = TK.chol_solve_factor(Ht, gt)
    assert torch.isfinite(fac).all()


def test_generators_match_jax_distributions():
    """The numpy generators keep the JAX generators' value ranges."""
    rng = np.random.default_rng(8)
    A, a_safe, lo, hi, gate, r0, u0 = TK.random_noslip_problem(rng, 16, 40)
    assert A.dtype == np.float32 and A.shape == (16, 40, 40)
    np.testing.assert_allclose(A, np.swapaxes(A, -1, -2), atol=1e-5)
    assert np.all(a_safe >= 1e-3) and np.all((-2 <= lo) & (lo <= -0.1))
    assert np.all((0.1 <= hi) & (hi <= 2.0)) and set(np.unique(gate)) <= {0, 1}
    assert np.all((lo <= u0) & (u0 <= hi))
    jar, Jp, D, fl, act, c1, c2 = TK.random_linesearch_problem(rng, 16, 64)
    assert act.dtype == np.bool_ and np.all(c1 < 0) and np.all(c2 > 0)
    assert np.all((0.1 <= D) & (D <= 10.0)) and 0.1 < np.mean(fl > 0) < 0.5
