"""Each CUDA kernel of the port against its plain PyTorch version, on
the card: the solver kernels on the shared probe generators, and the FK
kernel on each task's own tree with its per-env model fields.

These tests need an NVIDIA GPU and skip without one.  They import
neither JAX nor the JAX package, so they run on a machine with the card
and PyTorch alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`tests/conftest.py` configures JAX, which that machine does not have.)
`chip_smoke.py` holds the same kernels against their plain versions at
the main path's shapes.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mj_envs_torch.physics import kernels as TK


@pytest.fixture
def cuda():
    """The card, or a skip: the CUDA kernels run only on an NVIDIA GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run chip_smoke.py on the card)")
    return torch.device("cuda")


def _t(*xs):
    return [torch.as_tensor(np.asarray(x)) for x in xs]


def _np(x):
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------

def _both(fn, args, cuda):
    """fn on the card (kernel) and on the CPU (plain version)."""
    dev_args = [torch.as_tensor(np.asarray(a)).to(cuda) for a in args]
    out = fn(*dev_args)
    torch.cuda.synchronize()
    return out, fn(*_t(*args))


def _close(a, b, rtol, atol):
    a = [a] if isinstance(a, torch.Tensor) else a
    b = [b] if isinstance(b, torch.Tensor) else b
    for x, y in zip(a, b):
        np.testing.assert_allclose(_np(x), _np(y), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("nv", [1, 30, 32, 33, 36, 63, 64])
def test_cuda_chol_factor(cuda, nv):
    """K2 (K4's warp factor, written out) against its plain version, and
    K2 then K3 equal to the block factor-and-solve bit for bit: K2's
    factor is the block factor's."""
    H, g, G = TK.random_spd_problem(np.random.default_rng(9), 64, nv, 5)
    n = TK.launches["chol_factor"]
    (x_k, fac_k), (x_p, fac_p) = _both(TK.chol_solve_factor, (H, g), cuda)
    assert TK.launches["chol_factor"] == n + 1
    assert torch.all(torch.tril(fac_k, -1) == 0.0)
    _close((x_k, fac_k), (x_p, fac_p), 2e-4, 2e-5)
    Hc, Gc = torch.as_tensor(H).to(cuda), torch.as_tensor(G).to(cuda)
    X3 = TK.chol_solve_fac_cuda(fac_k, Gc)
    assert torch.equal(X3, TK.chol_solve_mat_block_cuda(Hc, Gc))


@pytest.mark.cuda
def test_cuda_chol_factor_not_positive_definite_gives_nan(cuda):
    H, _, _ = TK.random_spd_problem(np.random.default_rng(9), 8, 33, 1)
    H[3] = -H[3]
    fac = TK.chol_factor_cuda(torch.as_tensor(H).to(cuda))
    torch.cuda.synchronize()
    assert torch.isnan(fac[3]).any()
    assert torch.isfinite(fac[torch.arange(8, device=cuda) != 3]).all()


@pytest.mark.cuda
def test_cuda_chol_factor_refuses_nv_65(cuda):
    H, _, _ = TK.random_spd_problem(np.random.default_rng(9), 4, 65, 1)
    n = TK.launches["chol_factor"]
    with pytest.raises(ValueError, match=str(TK.CHOL_SOLVE_MAX_NV)):
        TK.chol_factor_cuda(torch.as_tensor(H).to(cuda))
    assert TK.launches["chol_factor"] == n


@pytest.mark.cuda
@pytest.mark.parametrize("nv", [30, 33, 36, 64])
@pytest.mark.parametrize("R", [1, 2, 31, 32, 33, 129, 132])
def test_cuda_chol_solve_fac(cuda, R, nv):
    """K3 at the tasks' nv and at its limit of 64 (the two register
    buckets), R from one right-hand side (a warp per env) through ragged
    last warps to noslip's 129; env 3's factor is NaN (the factor of a
    matrix that is not positive definite) and so must be its X, alone."""
    H, _, G = TK.random_spd_problem(np.random.default_rng(10), 64, nv, R)
    H[3] = -H[3]
    fac = _np(TK.chol_factor_plain(torch.as_tensor(H)))
    assert np.isnan(fac[3]).any()
    n = TK.launches["chol_solve_fac"]
    X_k, X_p = _both(TK.chol_solve_mat_fac, (fac, G), cuda)
    assert TK.launches["chol_solve_fac"] == n + 1
    assert torch.isnan(X_k[3]).all()
    ok = torch.arange(64) != 3
    assert torch.isfinite(X_k[ok]).all()
    _close(X_k[ok], X_p[ok], 2e-4, 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("nv", [30, 33, 36])
@pytest.mark.parametrize("R", [1, 129])
def test_cuda_chol_factor_then_subst_equals_block_solve(cuda, R, nv):
    """K2's factor then K3 is the block factor-and-solve (one block per
    env) bit for bit: K3 keeps the order of operations of its
    substitution; at R = 1 K4 is too."""
    H, _, G = (torch.as_tensor(x).to(cuda) for x in
               TK.random_spd_problem(np.random.default_rng(17), 64, nv, R))
    X3 = TK.chol_solve_fac_cuda(TK.chol_factor_cuda(H), G)
    X_block = TK.chol_solve_mat_block_cuda(H, G)
    torch.cuda.synchronize()
    assert torch.equal(X3, X_block)
    if R == 1:
        x4 = TK.chol_factor_solve_cuda(H, G[..., 0].contiguous())
        assert torch.equal(x4, X_block[..., 0])


@pytest.mark.cuda
def test_cuda_chol_solve_fac_refuses_nv_65(cuda):
    H, _, G = TK.random_spd_problem(np.random.default_rng(10), 4, 65, 3)
    fac = TK.chol_factor_plain(torch.as_tensor(H)).contiguous()
    n = TK.launches["chol_solve_fac"]
    with pytest.raises(ValueError, match=str(TK.CHOL_SUBST_MAX_NV)):
        TK.chol_solve_mat_fac(fac.to(cuda), torch.as_tensor(G).to(cuda))
    assert TK.launches["chol_solve_fac"] == n


@pytest.mark.cuda
@pytest.mark.parametrize("nv", [30, 33, 36, 64])
def test_cuda_chol_factor_solve(cuda, nv):
    """K4 at the tasks' nv (door and pen 30, hammer 33, relocate 36) and
    at its limit of 64 (two columns per lane); env 3 is not positive
    definite and must come out NaN."""
    H, g, _ = TK.random_spd_problem(np.random.default_rng(11), 64, nv, 1)
    H[3] = -H[3]
    n = TK.launches["chol_factor_solve"]
    x_k, x_p = _both(TK.chol_solve, (H, g), cuda)
    assert TK.launches["chol_factor_solve"] == n + 1
    assert torch.isnan(x_k[3]).any()
    _close(x_k[torch.arange(64) != 3], x_p[torch.arange(64) != 3],
           2e-4, 2e-5)


@pytest.mark.cuda
def test_cuda_chol_factor_solve_refuses_nv_65(cuda):
    H, g, _ = TK.random_spd_problem(np.random.default_rng(11), 4, 65, 1)
    n = TK.launches["chol_factor_solve"]
    with pytest.raises(ValueError, match=str(TK.CHOL_SOLVE_MAX_NV)):
        TK.chol_solve(*(torch.as_tensor(x).to(cuda) for x in (H, g)))
    assert TK.launches["chol_factor_solve"] == n


@pytest.mark.cuda
@pytest.mark.parametrize("R", [33, 296, 300])
def test_cuda_linesearch_cost(cuda, R):
    """K5 at hammer's 296 rows and at ragged row counts, against the plain
    version and, bit for bit, against the sequential search."""
    args = TK.random_linesearch_problem(np.random.default_rng(12), 64, R)
    n = TK.launches["linesearch_cost"]
    (a_k, c_k), (a_p, c_p) = _both(TK.linesearch_cost, args, cuda)
    assert TK.launches["linesearch_cost"] == n + 1
    # alpha: a float32 sum in another order may put phi'(alpha) on the
    # other side of a kink and move alpha within the search's last
    # bisection bracket (chip_smoke.py prints how far, between two row
    # orders of the plain version); the cost at alpha stays flat.
    _close(a_k, a_p, 0.0, 2e-3 * float(a_p.abs().max()))
    _close(c_k, c_p, 1e-5, 1e-6)
    assert torch.equal(a_k, TK.linesearch_seq_cuda(
        *(torch.as_tensor(np.asarray(x)).to(cuda) for x in args)))


@pytest.mark.cuda
def test_cuda_linesearch_cost_early_exit(cuda):
    """K5 stops at a Newton step that changes nothing; alpha is still
    the sequential search's after all 16 steps, bit for bit, and K7
    (the same fused search) agrees.  Envs 32..63 have no active
    row and phi'(a) = c2 (a - (1 + 2^-23)), c2 a power of two: the bracket
    ends at 2, step 1 lands on the root 1 + 2^-23, where phi' is 0, step
    2 bisects [1, 1 + 2^-23] back to 1 (ties to even) and step 3 repeats
    step 2's state: 3 steps.  Envs 0..31 are the generator's problem."""
    rng = np.random.default_rng(18)
    args = list(TK.random_linesearch_problem(rng, 64, 296))
    args[4][32:] = False
    c2 = np.exp2(rng.integers(-2, 3, 32)).astype(np.float32)
    args[6][32:] = c2
    args[5][32:] = -c2 * np.float32(1 + 2.0 ** -23)
    dev = [torch.as_tensor(np.asarray(x)).to(cuda) for x in args]
    steps = torch.zeros(64, dtype=torch.int32, device=cuda)
    a_k, c_k = TK.linesearch_cost_cuda(*dev, 12, 16, steps=steps)
    torch.cuda.synchronize()
    assert torch.equal(a_k, TK.linesearch_seq_cuda(*dev, 12, 16))
    assert torch.equal(a_k, TK.linesearch_cuda(*dev, 12, 16))
    assert (steps[32:] == 3).all() and (a_k[32:] == 1.0).all()
    assert int(steps.min()) >= 1 and int(steps.max()) <= 16
    a_p, c_p = TK.linesearch_cost_plain(*_t(*args), 12, 16)
    _close(a_k, a_p, 0.0, 2e-3 * float(a_p.abs().max()))
    _close(c_k, c_p, 1e-5, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 31, 32, 33, 126, 129, 132, 160, 161, 256])
def test_cuda_noslip_sweep(cuda, R):
    """K6 at tol 0 against its plain version: R through ragged last
    lanes and chunks, both row buckets (160 and 256 rows)."""
    args = TK.random_noslip_problem(np.random.default_rng(13), 16, R)
    n = TK.launches["noslip_sweep"]
    u_k, u_p = _both(lambda *a: TK.noslip_sweep(*a, 20, tol=0.0), args, cuda)
    assert TK.launches["noslip_sweep"] == n + 1
    _close(u_k, u_p, 1e-5, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [3, 20])
def test_cuda_noslip_sweep_tol_exit(cuda, iters):
    """At tol 1e-3 each env runs 1 .. iters sweeps and ends where tol = 0
    ends after that many sweeps, bit for bit."""
    args = [torch.as_tensor(x).to(cuda) for x in
            TK.random_noslip_problem(np.random.default_rng(22), 64, 129)]
    sweeps = torch.zeros(64, dtype=torch.int32, device=cuda)
    u_tol = TK.noslip_sweep_cuda(*args, iters, 1e-3, sweeps=sweeps)
    torch.cuda.synchronize()
    assert int(sweeps.min()) >= 1 and int(sweeps.max()) <= iters
    for n in sweeps.unique().tolist():
        ran = sweeps == n
        assert torch.equal(u_tol[ran], TK.noslip_sweep_cuda(*args, n, 0.0)[ran])


@pytest.mark.cuda
def test_cuda_noslip_sweep_empty_rows(cuda):
    """Empty contact slots, as a real chunk has (A row and column 0, r 0,
    gate 0): the kernel agrees with its plain version and leaves those
    rows at u0 = 0."""
    args = TK.random_noslip_problem(np.random.default_rng(23), 32, 129,
                                    empty=96)
    u_k, u_p = _both(lambda *a: TK.noslip_sweep(*a, 20, tol=0.0), args, cuda)
    _close(u_k, u_p, 1e-5, 1e-5)
    assert torch.all(u_k[:, -96:] == 0.0)


@pytest.mark.cuda
def test_cuda_noslip_sweep_nan_in_a_gate0_column(cuda):
    """A NaN in column k0 of A, a row that cannot move (gate 0), still
    reaches r through A * 0, as in the scan: every gated row j with a NaN
    A[j, k0] ends at lo[j] (the kernel's fmaxf of NaN and lo is lo; the
    plain version's torch.maximum, like jnp.clip, keeps the NaN)."""
    args = TK.random_noslip_problem(np.random.default_rng(24), 16, 129)
    A, lo, gate = args[0], args[2], args[4]
    k0 = 40
    gate[:, k0] = 0.0
    A[:, ::2, k0] = np.nan
    u = TK.noslip_sweep(*(torch.as_tensor(x).to(cuda) for x in args), 20,
                        tol=0.0)
    torch.cuda.synchronize()
    hit = np.isnan(A[:, :, k0]) & (gate > 0)
    assert hit.any()
    np.testing.assert_array_equal(_np(u)[hit], lo[hit])


@pytest.mark.cuda
def test_cuda_noslip_sweep_refuses_R_above_its_limit(cuda):
    R = TK.NOSLIP_MAX_R + 1
    args = [torch.as_tensor(x).to(cuda) for x in
            TK.random_noslip_problem(np.random.default_rng(25), 2, R)]
    n = TK.launches["noslip_sweep"]
    with pytest.raises(ValueError, match=str(TK.NOSLIP_MAX_R)):
        TK.noslip_sweep(*args, 20, tol=0.0)
    assert TK.launches["noslip_sweep"] == n


@pytest.mark.cuda
def test_cuda_linesearch(cuda):
    args = TK.random_linesearch_problem(np.random.default_rng(14), 64, 296)
    n = TK.launches["linesearch"]
    a_k, a_p = _both(TK.linesearch, args, cuda)
    assert TK.launches["linesearch"] == n + 1
    # alpha as in test_cuda_linesearch_cost; K5 and K7 run one search.
    _close(a_k, a_p, 0.0, 2e-3 * float(a_p.abs().max()))
    a_c, _ = TK.linesearch_cost(*(torch.as_tensor(np.asarray(x)).to(cuda)
                                  for x in args))
    assert torch.equal(a_k, a_c)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [33, 296, 300])
def test_cuda_linesearch_equals_sequential_search(cuda, R):
    """K7 (the fused search) is the sequential search and K5's alpha bit
    for bit, at hammer's 296 rows and at ragged row counts; the
    reference is not counted as a launch of K7."""
    args = [torch.as_tensor(np.asarray(x)).to(cuda) for x in
            TK.random_linesearch_problem(np.random.default_rng(26), 64, R)]
    n = TK.launches["linesearch"]
    a_seq = TK.linesearch_seq_cuda(*args)
    assert TK.launches["linesearch"] == n
    a_k = TK.linesearch_cuda(*args)
    a_c, _ = TK.linesearch_cost_cuda(*args)
    torch.cuda.synchronize()
    assert torch.equal(a_k, a_seq) and torch.equal(a_k, a_c)


@pytest.mark.cuda
def test_cuda_chol_solve_mat(cuda):
    H, _, G = TK.random_spd_problem(np.random.default_rng(15), 64, 33, 129)
    n = TK.launches["chol_solve_mat"]
    X_k, X_p = _both(TK.chol_solve_mat, (H, G), cuda)
    assert TK.launches["chol_solve_mat"] == n + 1
    _close(X_k, X_p, 2e-4, 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("nv", [30, 33, 36, 64])
@pytest.mark.parametrize("R", [1, 129, 300])
def test_cuda_chol_solve_mat_equals_block_solve(cuda, R, nv):
    """K8 (K2's warp factor and K3's substitution in one launch; K4 at
    R = 1; a grid of blocks over the right-hand sides beyond 256, each
    factoring H again) is the block factor-and-solve bit for bit, at the
    tasks' nv and at its limit, with the plain version's tolerance
    beside it; the reference is not counted as a launch of K8."""
    H, _, G = TK.random_spd_problem(np.random.default_rng(27), 64, nv, R)
    Hc, Gc = torch.as_tensor(H).to(cuda), torch.as_tensor(G).to(cuda)
    n = TK.launches["chol_solve_mat"]
    X_block = TK.chol_solve_mat_block_cuda(Hc, Gc)
    assert TK.launches["chol_solve_mat"] == n
    X_k = TK.chol_solve_mat_cuda(Hc, Gc)
    torch.cuda.synchronize()
    assert torch.equal(X_k, X_block)
    _close(X_k, TK.chol_solve_mat_plain(*_t(H, G)), 2e-4, 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 129])
def test_cuda_chol_solve_mat_not_positive_definite_gives_nan(cuda, R):
    H, _, G = TK.random_spd_problem(np.random.default_rng(28), 8, 33, R)
    H[3] = -H[3]
    X = TK.chol_solve_mat_cuda(*(torch.as_tensor(x).to(cuda) for x in (H, G)))
    torch.cuda.synchronize()
    assert torch.isnan(X[3]).all()
    assert torch.isfinite(X[torch.arange(8, device=cuda) != 3]).all()


@pytest.mark.cuda
def test_cuda_chol_solve_mat_refuses_nv_65(cuda):
    H, _, G = TK.random_spd_problem(np.random.default_rng(28), 4, 65, 3)
    n = TK.launches["chol_solve_mat"]
    with pytest.raises(ValueError, match=str(TK.CHOL_SOLVE_MAX_NV)):
        TK.chol_solve_mat(*(torch.as_tensor(x).to(cuda) for x in (H, G)))
    assert TK.launches["chol_solve_mat"] == n


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["hammer-v0", "door-v0", "pen-v0",
                                  "relocate-v0"])
def test_cuda_fk(cuda, task):
    """K1 on the task's tree, with the task's per-env fields from its
    reset (hammer's with the mass variation, so body_mass is per env
    too), against the plain version on the CPU: 2e-5 * max(1, |x|)."""
    from mj_envs_torch import envs
    from mj_envs_torch.envs.base import _apply_var
    from mj_envs_torch.parallel.vector import VectorEnv
    from mj_envs_torch.physics import kinematics as K
    env = envs.make(task, device=cuda,
                    variation_type="mass" if task == "hammer-v0" else None)
    B = 64
    st = VectorEnv(env, B).reset(seed=1)
    m = _apply_var(env.model, st.var)
    rng = np.random.default_rng(16)
    qpos = env.model.qpos0 + 0.3 * torch.as_tensor(
        rng.standard_normal((B, env.nq)), dtype=torch.float32, device=cuda)
    n = TK.launches["fk"]
    k = K.kinematics(m, qpos)
    torch.cuda.synchronize()
    assert TK.launches["fk"] == n + 1
    p = K.kinematics_plain(m.to("cpu"), qpos.cpu())
    for f in K.Kin._fields:
        a, b = getattr(k, f).cpu(), getattr(p, f)
        assert a.shape == b.shape, f
        scale = max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= 2e-5 * scale, f


@pytest.mark.cuda
def test_cuda_render_matches_cpu(cuda):
    """The ray-caster on the card against the CPU on one state of 4
    hammer envs (a reset and two random steps on the CPU, the poses and
    per-env fields moved to the card), 128x128 from the pixel env's
    camera: no pixel more than 1.0 apart (the renderer's float64 hits on
    float32 inputs give both devices the same image; `chip_smoke.py`
    phase 8a holds 256 envs to a share of 0.005)."""
    from mj_envs_torch import envs
    from mj_envs_torch.envs.base import _apply_var
    from mj_envs_torch.envs.pixels import PixelObservationEnv
    from mj_envs_torch.parallel.vector import random_actions
    from mj_envs_torch.render import raster
    env_c = envs.make("hammer-v0", device="cpu")
    gen = env_c.generator(3)
    st = env_c.reset(4, gen)
    for _ in range(2):
        st = env_c.step_auto_reset(
            st, random_actions(gen, 4, env_c.nu, "cpu"), gen)
    cam = PixelObservationEnv(env_c).camera
    img_c = raster.render(_apply_var(env_c.model, st.var),
                          st.data.geom_xpos, st.data.geom_xmat, cam)
    env_k = envs.make("hammer-v0", device=cuda)
    st_k = st.map(lambda x: x.to(cuda))
    img_k = raster.render(_apply_var(env_k.model, st_k.var),
                          st_k.data.geom_xpos, st_k.data.geom_xmat,
                          cam.to(cuda))
    assert img_k.shape == (4, 128, 128, 3) and float(img_c.std()) > 5.0
    far = (img_k.cpu() - img_c).abs().amax(-1) > 1.0
    assert int(far.sum()) == 0, float(far.double().mean())


# ---------------------------------------------------------------------------
# The narrowphase kernels (csrc/narrow_cyl.cu, csrc/narrow_plain.cu)
# ---------------------------------------------------------------------------

def _same_or_both_nan(a, b):
    """Equal bit for bit (as torch.equal compares), NaN where the other
    is NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def _narrow_both(key, xpos, xmat, size, g1, g2, margin):
    """The kernel and the plain version (as `driver.narrowphase_all` calls
    it) on the card; one launch."""
    from mj_envs_torch.physics.collision import driver as C
    from mj_envs_torch.physics.collision import narrow_cuda as NC
    name = NC.KERNELS[key][0]
    n = TK.launches[name]
    out_k = NC.narrow_cuda(key, xpos, xmat, size, g1, g2, margin)
    torch.cuda.synchronize()
    assert TK.launches[name] == n + 1
    B = xpos.shape[0]
    sz = size if size.dim() == 3 else size.expand(B, -1, -1)
    return out_k, C.plain_group(key, xpos, xmat, sz, g1.long(), g2.long(),
                                margin)


# geom types: 0 plane, 3 capsule, 5 cylinder, 6 box
_NARROW_KEYS = [(0, 3), (0, 5), (0, 6), (3, 3), (3, 5), (3, 6), (5, 5),
                (5, 6), (6, 6)]
_NARROW_IDS = ["plane_capsule", "plane_cylinder", "plane_box",
               "capsule_capsule", "capsule_cylinder", "capsule_box",
               "cylinder_cylinder", "cylinder_box", "box_box"]


@pytest.mark.cuda
@pytest.mark.parametrize("key", _NARROW_KEYS, ids=_NARROW_IDS)
def test_cuda_narrow_cylinder_probes(cuda, key):
    """Each narrowphase kernel against its plain function on the card, bit
    for bit, on numpy probes that reach every branch (see
    `tests/narrow_probes.py`), each instance an env of two geoms with its
    own sizes (the per-env size path), at margins 0 and 0.01 (capsule-
    box's fallback reads it); NaN in env 5's positions, env 7's frame,
    env 9's sizes and coincident centres in env 11: a dist of env 5 NaN
    (box-box: a point of env 5 NaN, since its NaN poses fail every
    candidate test and give BIG dists), every output NaN where the plain
    version's is, and the rows without NaN finite."""
    from narrow_probes import random_pairs
    n = 1000
    xpos, xmat, size = random_pairs(np.random.default_rng(23), key, n)
    xpos[5] = np.nan
    xmat[7, 1, 0, 0] = np.nan
    size[9, 0, 1] = np.nan
    xpos[11, 1] = xpos[11, 0]
    args = [torch.as_tensor(x).to(cuda) for x in (xpos, xmat, size)]
    g = [torch.tensor([i], dtype=torch.int32, device=cuda) for i in (0, 1)]
    clean = ~torch.isin(torch.arange(n, device=cuda),
                        torch.tensor([5, 7, 9, 11], device=cuda))
    for margin in (0.0, 0.01):
        marg = torch.full((1,), margin, device=cuda)
        out_k, out_p = _narrow_both(key, *args, *g, marg)
        for what, a, b in zip(("dist", "pos", "nrm"), out_k, out_p):
            assert _same_or_both_nan(a, b), (what, margin)
            assert torch.isfinite(a[clean]).all()
        assert torch.isnan(out_k[1 if key == (6, 6) else 0][5]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("task,B,steps", [
    ("hammer-v0", 1, 3), ("hammer-v0", 77, 3), ("hammer-v0", 512, 30),
    ("door-v0", 1, 3), ("door-v0", 77, 3), ("door-v0", 512, 3),
    ("pen-v0", 1, 3), ("pen-v0", 77, 3), ("pen-v0", 512, 3),
    ("relocate-v0", 77, 3)])
def test_cuda_narrow_cylinder_real_states(cuda, task, B, steps):
    """Each of the task's groups with a kernel, kernel against plain
    function on the card, bit for bit, on the task's states after a reset
    and `steps` random steps (hammer at B = 512 after 30: all 257 pairs,
    the plain groups' 175 among them); with shared and per-env geom
    sizes; with one env NaN (its rows NaN in both).  The step itself
    launches one kernel a group a substep."""
    from mj_envs_torch import envs
    from mj_envs_torch.parallel.vector import VectorEnv, random_actions
    from mj_envs_torch.physics.collision import driver as C
    from mj_envs_torch.physics.collision import narrow_cuda as NC
    env = envs.make(task, device=cuda)
    venv = VectorEnv(env, B, chunk_size=512)
    gen = torch.Generator(device=cuda).manual_seed(5)
    st = venv.reset(seed=4)
    groups = [(k, p) for k, p in C._groups(env.spec) if k in NC.KERNELS]
    names = [NC.KERNELS[k][0] for k, _ in groups]
    for _ in range(steps):
        before = {k: TK.launches[k] for k in names}
        st = venv.step(st, random_actions(gen, B, env.nu, cuda))
        # one launch a group a substep (the reset does not collide)
        assert {k: TK.launches[k] - before[k] for k in names} \
            == dict.fromkeys(names, env.FRAME_SKIP)
    xpos, xmat = st.data.geom_xpos, st.data.geom_xmat
    nan = xpos.clone()
    nan[B // 2] = float("nan")
    size = env.model.geom_size
    rng = np.random.default_rng(8)
    per_env = (size * torch.as_tensor(
        rng.uniform(0.8, 1.2, (B,) + tuple(size.shape)),
        dtype=torch.float32, device=cuda)).contiguous()
    for key, pids in groups:
        tables = NC.group_tables(env.model, pids)
        for xp, sz in ((xpos, size), (xpos, per_env), (nan, size)):
            out_k, out_p = _narrow_both(key, xp, xmat, sz, *tables)
            for what, a, b in zip(("dist", "pos", "nrm"), out_k, out_p):
                assert _same_or_both_nan(a, b), (key, what)


@pytest.mark.cuda
def test_cuda_narrowphase_float64_launches_no_kernel(cuda):
    """float64 on the card takes the plain functions: narrowphase_all on
    hammer's float64 state launches none of the narrowphase kernels and
    equals the CPU's."""
    from mj_envs_torch import envs
    from mj_envs_torch.physics.collision import driver as C
    from mj_envs_torch.physics.collision import narrow_cuda as NC
    env = envs.make("hammer-v0", device=cuda, dtype=torch.float64)
    st = env.reset(4, env.generator(0))
    names = [name for name, _ in NC.KERNELS.values()]
    before = {k: TK.launches[k] for k in names}
    con = C.narrowphase_all(env.model, st.data)
    torch.cuda.synchronize()
    assert all(TK.launches[k] == before[k] for k in names)
    assert con.dist.dtype == torch.float64
    kin_c = SimpleNamespace(geom_xpos=st.data.geom_xpos.cpu(),
                            geom_xmat=st.data.geom_xmat.cpu())
    con_c = C.narrowphase_all(env.model.to("cpu"), kin_c)
    for a, b in zip(con[:3], con_c[:3]):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-9, atol=1e-9)


@pytest.mark.cuda
def test_cuda_narrowphase_float16_raises(cuda):
    """A float16 state on the card reaches a group with a kernel and
    raises, as every kernel's front end does for a dtype it does not
    take."""
    from mj_envs_torch import envs
    from mj_envs_torch.physics.collision import driver as C
    env = envs.make("hammer-v0", device=cuda)
    st = env.reset(2, env.generator(0))
    half = st.data.replace(geom_xpos=st.data.geom_xpos.half(),
                           geom_xmat=st.data.geom_xmat.half())
    with pytest.raises(TypeError, match="float32"):
        C.narrowphase_all(env.model, half)
