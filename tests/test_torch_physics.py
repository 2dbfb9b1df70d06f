"""The port's physics, module by module, against the JAX package on real
hammer-v0 states (float32, CPU).

The states come from a short JAX f32 rollout with seeded random actions
(as `tests/test_kernels.py::test_make_rows_fast_matches_ref_on_env_states`
takes them).  Each stage gets the JAX stage's own inputs, carried across
as numpy arrays, so an error in one stage cannot hide or compound in the
next.  The port runs its plain PyTorch kernel versions here (CPU
tensors); the JAX side runs its CPU path (vmapped references).

Tolerances: elementwise stages at rtol 1e-5 / atol 1e-5.  The solver
stages iterate (Newton with an early exit, 20 Gauss-Seidel sweeps) on
float32 sums taken in another order, so they are held at the bounds
stated beside them, a few times what was measured.
"""
import numpy as np
import pytest
import torch

import jax

from mj_envs_tpu import envs as jenvs
from mj_envs_tpu.envs.base import _apply_var as j_apply_var
from mj_envs_tpu.physics import actuation as JA
from mj_envs_tpu.physics import constraint as JCN
from mj_envs_tpu.physics import dynamics as JD
from mj_envs_tpu.physics import kernels as JKR
from mj_envs_tpu.physics import kinematics as JK
from mj_envs_tpu.physics import pipeline as JP
from mj_envs_tpu.physics import solver as JS
from mj_envs_tpu.physics.collision import driver as JC
from mj_envs_torch import envs as tenvs
from mj_envs_torch.physics import actuation as TA
from mj_envs_torch.physics import constraint as TCN
from mj_envs_torch.physics import dynamics as TD
from mj_envs_torch.physics import kernels as TKR
from mj_envs_torch.physics import kinematics as TK
from mj_envs_torch.physics import pipeline as TP
from mj_envs_torch.physics import solver as TS
from mj_envs_torch.physics.collision import driver as TC
from mj_envs_torch.physics.model import Data, Model

B = 6            # envs
SUBSTEPS = 40    # JAX physics substeps before the states are taken
ELEM = dict(rtol=1e-5, atol=1e-5)


def tt(x):
    """A JAX (or numpy) array as a CPU tensor."""
    return torch.as_tensor(np.array(x))


def close(t, j, err_msg="", **tol):
    tol = tol or ELEM
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               err_msg=err_msg, **tol)


@pytest.fixture(scope="module")
def world():
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)   # six xdist workers share the CPU
    yield make_world()
    torch.set_num_threads(n_threads)


def make_world():
    """JAX and port models on identical arrays, and B hammer states."""
    jenv = jenvs.make("hammer-v0")
    jm = jenv.model
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    st = jax.jit(jax.vmap(jenv.reset))(keys)
    var = st.var

    def substep(var, d, ctrl):
        return JP.step(j_apply_var(jm, var), d, ctrl)

    jstep = jax.jit(jax.vmap(substep))
    rng = np.random.default_rng(0)
    mid, half = np.asarray(jenv.act_mid), np.asarray(jenv.act_rng)
    d = st.data
    for _ in range(SUBSTEPS):
        a = rng.uniform(-1.0, 1.0, (B, jenv.nu)).astype(np.float32)
        d = jstep(var, d, mid + a * half)
    ctrl = (mid + rng.uniform(-1.0, 1.0, (B, jenv.nu)) * half
            ).astype(np.float32)

    tenv = tenvs.make("hammer-v0", device="cpu")
    tm = Model.from_numpy({n: np.asarray(getattr(jm, n))
                           for n in Model.leaf_names()},
                          tenv.model.spec, device="cpu")
    tm = tm.replace(body_pos=tt(var.body_pos))
    return dict(jm=jm, var=var, d=d, ctrl=ctrl, jstep=jstep, tm=tm,
                ncmax=JP._ncmax(jm.spec))


def jvmap(world, fn):
    """jit(vmap(fn(model_with_env_var, *args))) over the env axis."""
    jm = world["jm"]
    return jax.jit(jax.vmap(lambda var, *a: fn(j_apply_var(jm, var), *a)))


def cached(fn):
    """Compute a JAX stage once per module (each jit is a fresh compile)."""
    def wrapper(world, *args):
        key = (fn.__name__,) + args
        if key not in world:
            world[key] = fn(world, *args)
        return world[key]
    return wrapper


@cached
def jkin(world):
    return jvmap(world, JK.kinematics)(world["var"], world["d"].qpos)


def tkin(jk):
    return TK.Kin(**{f: tt(getattr(jk, f)) for f in TK.Kin._fields})


@cached
def jcollide(world, ncmax):
    return jvmap(world, lambda m, k: JC.collide(m, k, ncmax))(
        world["var"], jkin(world))


def test_kinematics(world):
    jk = jkin(world)
    k = TK.kinematics(world["tm"], tt(world["d"].qpos))
    for f in TK.Kin._fields:
        close(getattr(k, f), getattr(jk, f), f)


def test_smooth_dynamics_and_actuation(world):
    """crb, com velocity + bias force, passive force, tendons and
    actuation, from the same kinematics."""
    d = world["d"]

    def smooth(m, kin, qpos, qvel, ctrl):
        vel = JD.com_velocity(m, kin, qvel)
        return (JD.crb(m, kin), JD.bias_force(m, kin, vel, qvel),
                JD.passive_force(m, qpos, qvel),
                JA.actuation(m, qpos, qvel, ctrl))

    jk = jkin(world)
    M_j, bias_j, pas_j, act_j = jvmap(world, smooth)(
        world["var"], jk, d.qpos, d.qvel, world["ctrl"])
    m, kin = world["tm"], tkin(jk)
    qpos, qvel, ctrl = tt(d.qpos), tt(d.qvel), tt(world["ctrl"])
    close(TD.crb(m, kin), M_j, "crb")
    vel = TD.com_velocity(m, kin, qvel)
    close(TD.bias_force(m, kin, vel, qvel), bias_j, "bias_force")
    close(TD.passive_force(m, qpos, qvel), pas_j, "passive_force")
    act = TA.actuation(m, qpos, qvel, ctrl)
    for f in TA.Actuation._fields:
        close(getattr(act, f), getattr(act_j, f), f)


def _groups(spec):
    """(type pair, slot range) of each narrowphase group."""
    out, start = [], 0
    for key, pids in TC._groups(spec):
        n = len(pids) * TC._SLOTS[key]
        out.append((key, slice(start, start + n)))
        start += n
    assert start == spec.ncon_cap
    return out


def test_narrowphase_per_pair_type(world):
    """Group by group (hammer's nine pair types): which slots are in
    contact, exactly; distance, position and normal of those slots; and
    the distance of every slot.

    Box-box slots out of contact are the one exception: a face-clipping
    candidate whose incident edge is nearly parallel to a clip line
    amplifies float32 rounding (t = (line - q) / den), so its distance
    may differ by ~1e-4 and its validity may flip between two coincident
    candidates.  Those slots are held at atol 1e-3 where both packages
    emit one; slots in contact never are such candidates here."""
    con_j, _ = jcollide(world, world["ncmax"])
    m = world["tm"]
    con = TC.narrowphase_all(m, tkin(jkin(world)))
    groups = _groups(m.spec)
    assert len(groups) == 9
    act_j = np.asarray(con_j.active)
    assert act_j.sum() >= B, "the states hold too few contacts"
    for key, sl in groups:
        a = act_j[:, sl]
        at = tt(a)
        np.testing.assert_array_equal(con.active[:, sl].numpy(), a,
                                      err_msg=f"{key}")
        for f in ("dist", "pos", "nrm"):
            close(getattr(con, f)[:, sl][at],
                  np.asarray(getattr(con_j, f))[:, sl][a], f"{f} {key}")
        d_t, d_j = con.dist[:, sl].numpy(), np.asarray(con_j.dist)[:, sl]
        if key == (TC.GEOM_BOX, TC.GEOM_BOX):
            both = (d_t < TC.NP.BIG) & (d_j < TC.NP.BIG)
            np.testing.assert_allclose(d_t[both], d_j[both], rtol=0,
                                       atol=1e-3, err_msg=f"dist {key}")
        else:
            close(con.dist[:, sl], d_j, f"dist {key}")


def _random_rot(rng, n):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1).reshape(n, 3, 3)


@pytest.mark.parametrize("name", ["plane_sphere", "sphere_sphere",
                                  "sphere_capsule", "sphere_cylinder",
                                  "sphere_box"])
def test_sphere_pair_functions(name):
    """The five sphere pair types (relocate runs plane_sphere,
    sphere_capsule and sphere_box; the other two complete the table) on
    seeded random geometry, sphere centres inside and outside geom2, at
    the narrowphase tolerance in contact (1e-5)."""
    key = next(k for k, (fn, _) in TC._FNS.items() if fn.__name__ == name)
    rng = np.random.default_rng(list(TC._FNS).index(key))
    n = 256
    p1 = rng.uniform(-0.1, 0.1, (n, 3))
    p2 = rng.uniform(-0.1, 0.1, (n, 3))
    m1, m2 = _random_rot(rng, n), _random_rot(rng, n)
    s1 = np.concatenate([rng.uniform(0.01, 0.06, (n, 1)),
                         np.zeros((n, 2))], axis=1)
    s2 = rng.uniform(0.02, 0.08, (n, 3))
    if name == "plane_sphere":           # geom1 is the plane, geom2 the sphere
        s1, s2 = s2, s1
    args = [a.astype(np.float32) for a in (p1, m1, s1, p2, m2, s2)]
    margin = np.zeros(n, np.float32)
    jfn = getattr(JC.NP, name)
    d_j, p_j, n_j = jax.jit(jax.vmap(jfn))(*args, margin)
    d_t, p_t, n_t = getattr(TC.NP, name)(*(tt(a) for a in args), tt(margin))
    assert d_t.shape == (n, TC._SLOTS[key]) == np.asarray(d_j).shape
    assert TC._SLOTS == JC._SLOTS
    inside = np.asarray(d_j)[:, 0] < 0
    assert 0.1 < inside.mean() < 0.9, "need candidates in and out of contact"
    close(d_t, d_j, f"{name} dist")
    close(p_t, p_j, f"{name} pos")
    close(n_t, n_j, f"{name} nrm")


@pytest.mark.parametrize("ncmax", [32, 2])
def test_compaction_and_clipping(world, ncmax):
    """Slot order, the ncmax cap and `contacts_clipped` against the JAX
    batched compaction (`_compact_batched`, what `collide` runs under
    vmap); ncmax = 2 forces compaction to drop contacts."""
    con_j, _ = jcollide(world, 32)
    cc_j = jax.jit(lambda c: JC._compact_batched(world["jm"], c, ncmax))(
        con_j)
    m = world["tm"]
    con = TC.Contact(**{f: tt(getattr(con_j, f)) for f in TC.Contact._fields})
    cc = TC.compact(m, con, ncmax)
    act = np.asarray(cc_j.active)
    np.testing.assert_array_equal(cc.active.numpy(), act)
    for f in ("pairid", "geom1", "geom2", "condim"):
        np.testing.assert_array_equal(getattr(cc, f).numpy()[act],
                                      np.asarray(getattr(cc_j, f))[act], f)
    np.testing.assert_array_equal(cc.condim.numpy(), np.asarray(cc_j.condim))
    close(cc.dist, cc_j.dist, "dist")
    close(cc.pos[tt(act)], np.asarray(cc_j.pos)[act], "pos")
    close(cc.frame[tt(act)], np.asarray(cc_j.frame)[act],
          "frame")
    clipped_t = con.active.sum(-1) > ncmax
    clipped_j = np.asarray(con_j.active).sum(-1) > ncmax
    np.testing.assert_array_equal(clipped_t.numpy(), clipped_j)
    if ncmax == 2:
        assert clipped_j.any(), "no env had more than 2 contacts"


def test_make_tangents_seed_rule():
    """mju_makeFrame's seed: +Z when |n_z| < 0.5, else +Y."""
    n = np.random.default_rng(1).standard_normal((64, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    t1_j, t2_j = JC._make_tangents(jax.numpy.asarray(n))
    t1, t2 = TC._make_tangents(torch.as_tensor(n))
    close(t1, t1_j)
    close(t2, t2_j)


@cached
def _rows(world):
    d = world["d"]
    jk = jkin(world)
    _, cc_j = jcollide(world, world["ncmax"])
    rows_j = jvmap(world, JCN.make_rows)(world["var"], jk, d.qpos, d.qvel,
                                         cc_j)
    return jk, cc_j, rows_j


def test_make_rows_fast(world):
    """`_make_rows_fast` with the dense J (the JAX f32 default)."""
    jk, cc_j, rows_j = _rows(world)
    assert rows_j.Jbase is None
    cc = TC.CompactContacts(**{f: tt(getattr(cc_j, f))
                               for f in TC.CompactContacts._fields})
    d = world["d"]
    rows = TCN.make_rows(world["tm"], tkin(jk), tt(d.qpos), tt(d.qvel), cc)
    assert rows.J.shape == (B, 296, 33)
    for f in ("active", "oneside"):
        np.testing.assert_array_equal(getattr(rows, f).numpy(),
                                      np.asarray(getattr(rows_j, f)), f)
    for f in ("J", "aref", "R", "D", "floss", "pos"):
        close(getattr(rows, f), getattr(rows_j, f), f)
    assert np.asarray(rows_j.active)[:, -6 * 32:].any()


def _trows(rows_j):
    return TCN.Rows(**{f: None if getattr(rows_j, f) is None
                       else tt(getattr(rows_j, f)) for f in TCN.Rows._fields})


@cached
def _smooth_solve_inputs(world):
    """(M, qacc_smooth, M_fac) from the JAX stages."""
    d = world["d"]

    def f(m, qpos, qvel, ctrl, applied):
        kin = JK.kinematics(m, qpos)
        M = JD.crb(m, kin)
        vel = JD.com_velocity(m, kin, qvel)
        act = JA.actuation(m, qpos, qvel, ctrl)
        frc = act.qfrc_actuator + JD.passive_force(m, qpos, qvel) \
            + applied - JD.bias_force(m, kin, vel, qvel)
        qacc_smooth, fac = JKR.chol_solve_factor(M, frc)
        return M, qacc_smooth, fac

    return jvmap(world, f)(world["var"], d.qpos, d.qvel, world["ctrl"],
                           d.qfrc_applied)


# Measured on these states: max abs error 6e-5 on qacc (|qacc| up to
# 1e3), 2e-5 on efc_force (up to 5e1), 1.2e-4 on jar (up to 1.4e3).
NEWTON = dict(rtol=1e-4, atol=1e-3)


def test_newton_solve(world):
    d = world["d"]
    _, _, rows_j = _rows(world)
    M_j, qs_j, _ = _smooth_solve_inputs(world)
    iters = world["jm"].spec.iterations
    res_j = jax.jit(jax.vmap(lambda M, qs, r, w: JS.newton_solve(
        M, qs, r, w, iterations=iters)))(M_j, qs_j, rows_j,
                                         d.qacc_warmstart)
    res = TS.newton_solve(tt(M_j), tt(qs_j), _trows(rows_j),
                          tt(d.qacc_warmstart), iterations=iters)
    for f in ("qacc", "efc_force", "jar"):
        close(getattr(res, f), getattr(res_j, f), f, **NEWTON)


# Measured: noslip from the same Newton result, at most 4e-6 abs; one
# whole step (Newton and noslip on the port's own rows), qacc 1.2e-3 abs
# on |qacc| ~1e3 (1.1e-4 relative), efc_force and sensordata 2.5e-5.
NOSLIP = dict(rtol=1e-3, atol=1e-3)


def test_noslip(world):
    """The noslip post-pass from the same Newton result and M factor."""
    d = world["d"]
    _, _, rows_j = _rows(world)
    M_j, qs_j, fac_j = _smooth_solve_inputs(world)
    s = world["jm"].spec
    nfl = int(np.sum(s.dof_hasfrictionloss))
    nc = world["ncmax"]

    def both(M, qs, r, w, fac):
        res = JS.newton_solve(M, qs, r, w, iterations=s.iterations)
        return res, JS.noslip(M, r, res, nfl, nc, s.noslip_iterations,
                              M_fac=fac)

    res_j, ns_j = jax.jit(jax.vmap(both))(M_j, qs_j, rows_j,
                                          d.qacc_warmstart, fac_j)
    res_in = TS.SolveResult(*(tt(x) for x in res_j))
    ns = TS.noslip(tt(M_j), _trows(rows_j), res_in, nfl, nc,
                   s.noslip_iterations, M_fac=tt(fac_j))
    for f in ("qacc", "efc_force", "jar"):
        close(getattr(ns, f), getattr(ns_j, f), f, **NOSLIP)


def _tdata(d):
    return Data.from_numpy({f: np.asarray(getattr(d, f))
                            for f in Data.field_names()}, device="cpu")


def test_forward_core_and_step(world):
    """forward_core (read through the caches one `pipeline.step` writes)
    and the step itself: Euler with implicit damping."""
    d_j = world["d"]
    out_j = world["jstep"](world["var"], d_j, world["ctrl"])
    m = world["tm"]
    d = _tdata(d_j)
    ctrl = tt(world["ctrl"])
    fo = TP.forward_core(m, d.qpos, d.qvel, ctrl, d.qacc_warmstart,
                         d.qfrc_applied)
    out = TP.step(m, d, ctrl)
    assert fo.contacts_clipped.shape == (B,)
    np.testing.assert_array_equal(out.ncon_active.numpy(),
                                  np.asarray(out_j.ncon_active))
    close(fo.qacc, out_j.qacc, "forward_core qacc", **NOSLIP)
    for f in ("xpos", "xquat", "xipos", "geom_xpos", "geom_xmat",
              "site_xpos", "site_xmat", "subtree_com", "ten_length",
              "actuator_force"):
        close(getattr(out, f), getattr(out_j, f), f)
    close(out.sensordata, out_j.sensordata, "sensordata", **NOSLIP)
    close(out.efc_force, out_j.efc_force, "efc_force", **NOSLIP)
    for f in ("qacc", "qacc_warmstart"):
        close(getattr(out, f), getattr(out_j, f), f, **NOSLIP)
    for f in ("qpos", "qvel", "time"):
        close(getattr(out, f), getattr(out_j, f), f)
    close(out.ctrl, out_j.ctrl, "ctrl")

    # forward (mj_forward) at the same state and ctrl writes the caches
    # and qacc that step computed, and leaves the state alone.
    fwd = TP.forward(m, d.replace(ctrl=ctrl))
    for f in ("xpos", "site_xpos", "actuator_force"):
        close(getattr(fwd, f), getattr(out_j, f), f"forward {f}")
    for f in ("qacc", "sensordata", "efc_force"):
        close(getattr(fwd, f), getattr(out_j, f), f"forward {f}", **NOSLIP)
    assert torch.equal(fwd.qpos, d.qpos) and torch.equal(fwd.qvel, d.qvel)


def test_newton_tol_scale_knob(world, monkeypatch):
    """MJE_NEWTON_TOL_SCALE acts on the port's f32 substep as on the JAX
    package's.  At 1e5 (a Newton exit at ~1.2 % of the cost) the port's
    step matches a JAX step traced after the variable was set, at the
    bounds of test_forward_core_and_step, and moves qacc by more than
    those bounds from the port's step at the default.  The states are
    the world's with qvel + 3 N(0, 1), so that Newton takes several
    iterations (from the world's own states one iteration nearly solves
    the problem, and the exit moves qacc by a tenth of the bounds)."""
    qvel = np.asarray(world["d"].qvel) + 3.0 * np.random.default_rng(
        5).standard_normal(world["d"].qvel.shape).astype(np.float32)
    d_j = world["d"].replace(qvel=jax.numpy.asarray(qvel))
    m = world["tm"]
    d = _tdata(d_j)
    ctrl = tt(world["ctrl"])
    monkeypatch.delenv("MJE_NEWTON_TOL_SCALE", raising=False)
    default = TP.step(m, d, ctrl)
    monkeypatch.setenv("MJE_NEWTON_TOL_SCALE", "1e5")
    out = TP.step(m, d, ctrl)
    jm = world["jm"]
    # A new jit traces anew, and so reads the variable (world["jstep"]
    # holds the default).
    out_j = jax.jit(jax.vmap(lambda var, dd, c: JP.step(
        j_apply_var(jm, var), dd, c)))(world["var"], d_j, world["ctrl"])
    for f in ("qacc", "efc_force", "sensordata"):
        close(getattr(out, f), getattr(out_j, f), f, **NOSLIP)
    for f in ("qpos", "qvel"):
        close(getattr(out, f), getattr(out_j, f), f)
    assert not np.allclose(out.qacc.numpy(), default.qacc.numpy(),
                           **NOSLIP), "the knob did not move the port's qacc"


def test_noslip_tol_knob(world, monkeypatch):
    """MJE_NOSLIP_TOL reaches the noslip sweep through forward_core (on
    the CPU its plain version runs the fixed sweeps and ignores it, as
    the JAX package's CPU path does)."""
    d = _tdata(world["d"])
    ctrl = tt(world["ctrl"])
    seen = []
    sweep = TKR.noslip_sweep

    def spy(A, a_safe, lo, hi, gate, r0, u0, iters, tol=0.0):
        seen.append(tol)
        return sweep(A, a_safe, lo, hi, gate, r0, u0, iters, tol)

    monkeypatch.setattr(TKR, "noslip_sweep", spy)
    for value in ("0", "5e-3"):
        monkeypatch.setenv("MJE_NOSLIP_TOL", value)
        TP.forward_core(world["tm"], d.qpos, d.qvel, ctrl, d.qacc_warmstart,
                        d.qfrc_applied)
    assert seen == [0.0, 5e-3]
