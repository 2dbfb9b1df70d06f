"""The port's float64 oracle-parity path against the JAX package's, stage
by stage and as whole substeps (CPU); the one-substep checks of all four
tasks are in `test_torch_f64_substeps.py`, so that the two files run on
two workers.

The JAX side runs its float64 branches under `jax.vmap` (the plain
references: `_kinematics_ref`, the einsum CRB and bias, `_make_rows_ref`,
the non-fused Newton with the alpha-only linesearch and the 10 eps exit,
noslip through inv(M) with its fixed sweeps); the port runs its own
float64 branches, which launch no kernel on any device.

States: B hammer envs from a JAX float64 reset, stepped SUBSTEPS physics
substeps with seeded random controls, so that they hold contacts; each
stage gets the JAX stage's own inputs, as in `tests/test_torch_physics.py`.

Bounds are measured floors.  Torch's CPU BLAS and XLA's CPU dot sum in
other orders, and a contact-rich stiff step amplifies a 1e-17 change
past 1e-12 within a few steps (PARITY.md), so bit equality is not the
bar.  `tests/measure_torch_f64_floors.py` prints each error below for
seeds 0, 1 and 2 (the seed drives the reset keys and the controls);
each bound is 2-4x the worst of the three, and the tests run seed 0.

A stage whose absolute bound would sit below 4 ulp of its own largest
value is bounded in units of eps64 x its max |value| instead
(`REL_BOUNDS`, k = 4x the worst over seeds 0-2 at 1 and at 6 torch
threads, `measure_torch_f64_floors.py stages`): an error of one ulp of
one of its values must not fail it on a machine that sums in another
order.  Worst in those units: FK 0.0825, CRB 0.907, rows J 0.0468,
aref 0.103, R 0.0546, noslip qacc 2.39e-4 (5.6e-17, one ulp of a value
in [0.25, 0.5), against a max |qacc| of 1.0e3-1.5e3), noslip efc_force
0.0522.

Measured worst over seeds 0-2, max abs (`measure_torch_f64_floors.py
f64`):

* FK every field 1.1e-15; CRB 1.1e-16; bias 7.1e-15;
* collide (dist, pos, frame on active slots) 2.7e-15;
* `_make_rows_ref` J 1.0e-17, aref 2.1e-14, R 1.3e-15;
* Newton qacc 5.6e-12, efc_force 1.7e-13;
* noslip (from the same Newton result) qacc 5.6e-17, efc_force 1.1e-16
  (6.9e-18 and 5.6e-17 when first measured, before the stage bounds
  became relative);
* one substep from states 10 substeps after a reset, qacc (forward_core
  and step) / qpos and qvel: hammer 1.3e-12 / 3.6e-15, door 7.3e-11 /
  3.6e-14, pen 1.4e-12 / 1.8e-15, relocate 1.3e-9 / 2.4e-12;
* hammer, 50 substeps from a reset: qpos 1.4e-12, qvel 1.2e-10.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

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
from mj_envs_torch.physics import constraint as TCN
from mj_envs_torch.physics import dynamics as TD
from mj_envs_torch.physics import kernels as TKR
from mj_envs_torch.physics import kinematics as TK
from mj_envs_torch.physics import pipeline as TP
from mj_envs_torch.physics import solver as TS
from mj_envs_torch.physics.collision import driver as TC
from mj_envs_torch.physics.model import Data, Model

B = 4
SUBSTEPS = 40
TASKS = ("hammer-v0", "door-v0", "pen-v0", "relocate-v0")
F64 = jnp.float64

EPS64 = float(np.finfo(np.float64).eps)

# Bounds (max abs), each 2-4x the worst measured over seeds 0-2 (the
# module docstring).
BOUNDS = {
    "bias": 2e-14,
    "collide": 8e-15,
    "newton qacc": 2e-11, "newton efc_force": 5e-13,
    "traj qpos": 4e-12, "traj qvel": 4e-10,
}
# Bounds in units of eps64 x the stage's max |value|, each 4x the worst
# measured over seeds 0-2 at 1 and 6 threads (the module docstring).
REL_BOUNDS = {
    "fk": 0.33, "crb": 3.7,
    "rows J": 0.19, "rows aref": 0.42, "rows R": 0.22,
    "noslip qacc": 9.6e-4, "noslip efc_force": 0.21,
}
SUBSTEP_BOUNDS = {
    "hammer-v0": {"substep qacc": 4e-12, "substep state": 1e-14},
    "door-v0": {"substep qacc": 2e-10, "substep state": 1e-13},
    "pen-v0": {"substep qacc": 4e-12, "substep state": 5e-15},
    "relocate-v0": {"substep qacc": 4e-9, "substep state": 6e-12},
}


def t64(x):
    return torch.as_tensor(np.array(x, dtype=np.float64))


def tt(x):
    """A JAX array as a CPU tensor of its own dtype."""
    return torch.as_tensor(np.array(x))


def err(got, want, mask=None):
    """max |got - want| (over `mask` if given)."""
    g = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    w = np.asarray(want)
    d = np.abs(g.astype(np.float64) - w.astype(np.float64))
    if mask is not None:
        d = d[mask]
    return float(d.max()) if d.size else 0.0


def _tdata(d):
    return Data.from_numpy({f: np.asarray(getattr(d, f))
                            for f in Data.field_names()}, device="cpu")


def make_world(task, seed, substeps=SUBSTEPS):
    """JAX float64 env of `task`, B states after `substeps` substeps from
    a reset with keys and controls drawn from `seed`, the jitted JAX
    substep and the port's model on the JAX model's arrays (with the
    states' per-env fields)."""
    jenv = jenvs.make(task, dtype=F64)
    jm = jenv.model
    st = jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(seed), B))
    var = st.var
    jstep = jax.jit(jax.vmap(lambda v, d, c: JP.step(j_apply_var(jm, v),
                                                     d, c)))
    rng = np.random.default_rng(seed)
    mid, half = np.asarray(jenv.act_mid), np.asarray(jenv.act_rng)

    def ctrl():
        return mid + rng.uniform(-1.0, 1.0, (B, jenv.nu)) * half

    d = st.data
    for _ in range(substeps):
        d = jstep(var, d, ctrl())
    spec = tenvs.make(task, device="cpu", dtype=torch.float64).spec
    tm = Model.from_numpy({n: np.asarray(getattr(jm, n))
                           for n in Model.leaf_names()}, spec, device="cpu")
    tm = tm.replace(**{f: t64(getattr(var, f)) for f in
                       var.__dataclass_fields__
                       if getattr(var, f) is not None})
    return dict(jm=jm, var=var, d=d, ctrl=ctrl(), next_ctrl=ctrl,
                jstep=jstep, tm=tm, ncmax=JP._ncmax(jm.spec))


def jvmap(w, fn):
    jm = w["jm"]
    return jax.jit(jax.vmap(lambda var, *a: fn(j_apply_var(jm, var), *a)))


def stage_errors(seed, scales=None):
    """Each stage of one hammer substep: the port against the JAX float64
    branch on the JAX stage's inputs; {name: max abs error}.  `scales`,
    when given, receives each stage's max |value| (of the JAX side)."""
    w = make_world("hammer-v0", seed)
    d, s, m = w["d"], w["jm"].spec, w["tm"]
    nc = w["ncmax"]
    out = {}
    scales = {} if scales is None else scales

    def put(name, *pairs, mask=None):
        out[name] = max(err(g, want, mask) for g, want in pairs)
        scales[name] = max(err(np.zeros(np.shape(want)), want, mask)
                           for _, want in pairs)

    def front(mm, qpos, qvel, ctrl, applied):
        kin = JK.kinematics(mm, qpos)
        M = JD.crb(mm, kin)
        vel = JD.com_velocity(mm, kin, qvel)
        bias = JD.bias_force(mm, kin, vel, qvel)
        act = JA.actuation(mm, qpos, qvel, ctrl)
        frc = act.qfrc_actuator + JD.passive_force(mm, qpos, qvel) \
            + applied - bias
        qs = JKR.chol_solve(M, frc)
        _, cc = JC.collide(mm, kin, nc)
        rows = JCN.make_rows(mm, kin, qpos, qvel, cc)
        return kin, M, bias, qs, cc, rows

    kin_j, M_j, bias_j, qs_j, cc_j, rows_j = jvmap(w, front)(
        w["var"], d.qpos, d.qvel, w["ctrl"], d.qfrc_applied)
    qpos, qvel = t64(d.qpos), t64(d.qvel)

    kin = TK.kinematics(m, qpos)
    put("fk", *((getattr(kin, f), getattr(kin_j, f))
                for f in TK.Kin._fields))
    kin_t = TK.Kin(**{f: t64(getattr(kin_j, f)) for f in TK.Kin._fields})
    put("crb", (TD.crb(m, kin_t), M_j))
    vel = TD.com_velocity(m, kin_t, qvel)
    put("bias", (TD.bias_force(m, kin_t, vel, qvel), bias_j))

    _, cc = TC.collide(m, kin_t, nc)
    act = np.asarray(cc_j.active)
    assert np.array_equal(cc.active.numpy(), act) and act.any()
    assert np.array_equal(cc.pairid.numpy()[act],
                          np.asarray(cc_j.pairid)[act])
    put("collide", *((getattr(cc, f), getattr(cc_j, f))
                     for f in ("dist", "pos", "frame")), mask=act)

    cc_t = TC.CompactContacts(*(tt(x) for x in cc_j))
    rows = TCN.make_rows(m, kin_t, qpos, qvel, cc_t)
    assert rows.Jbase is None and rows_j.Jbase is None
    for f in ("active", "oneside"):
        assert np.array_equal(getattr(rows, f).numpy(),
                              np.asarray(getattr(rows_j, f))), f
    for f in ("J", "aref", "R"):
        put(f"rows {f}", (getattr(rows, f), getattr(rows_j, f)))
    assert err(rows.D, rows_j.D) <= 1e-9 * float(np.abs(rows_j.D).max())

    nfl = int(np.sum(s.dof_hasfrictionloss))

    def solve(M, qs, r, ws):
        res = JS.newton_solve(M, qs, r, ws, iterations=s.iterations)
        return res, JS.noslip(M, r, res, nfl, nc, s.noslip_iterations)

    res_j, ns_j = jax.jit(jax.vmap(solve))(M_j, qs_j, rows_j,
                                           d.qacc_warmstart)
    rows_t = TCN.Rows(*(tt(x) for x in rows_j[:-1]))      # Jbase None
    M_t, qs_t = t64(M_j), t64(qs_j)
    res = TS.newton_solve(M_t, qs_t, rows_t, t64(d.qacc_warmstart),
                          iterations=s.iterations)
    put("newton qacc", (res.qacc, res_j.qacc))
    put("newton efc_force", (res.efc_force, res_j.efc_force))
    ns = TS.noslip(M_t, rows_t, TS.SolveResult(*(t64(x) for x in res_j)),
                   nfl, nc, s.noslip_iterations)
    put("noslip qacc", (ns.qacc, ns_j.qacc))
    put("noslip efc_force", (ns.efc_force, ns_j.efc_force))
    return out


def substep_errors(task, seed):
    """One forward_core and one step of `task` from the world states."""
    w = make_world(task, seed, substeps=10)
    d_j = w["d"]
    out_j = w["jstep"](w["var"], d_j, w["ctrl"])
    d, ctrl = _tdata(d_j), t64(w["ctrl"])
    fo = TP.forward_core(w["tm"], d.qpos, d.qvel, ctrl, d.qacc_warmstart,
                         d.qfrc_applied)
    out = TP.step(w["tm"], d, ctrl)
    for f in ("xpos", "site_xpos", "actuator_force"):
        assert err(getattr(out, f), getattr(out_j, f)) < 1e-12, (task, f)
    return {"substep qacc": max(err(fo.qacc, out_j.qacc),
                                err(out.qacc, out_j.qacc)),
            "substep state": max(err(out.qvel, out_j.qvel),
                                 err(out.qpos, out_j.qpos))}


def trajectory_errors(seed, substeps=50):
    """50 hammer substeps from a float64 reset, the same controls on
    both sides; the worst qpos and qvel error over the steps."""
    w = make_world("hammer-v0", seed, substeps=0)
    d_j, d = w["d"], _tdata(w["d"])
    ctrl = w["ctrl"]
    eq = ev = 0.0
    for _ in range(substeps):
        d_j = w["jstep"](w["var"], d_j, ctrl)
        d = TP.step(w["tm"], d, t64(ctrl))
        eq = max(eq, err(d.qpos, d_j.qpos))
        ev = max(ev, err(d.qvel, d_j.qvel))
        ctrl = w["next_ctrl"]()
    assert bool(torch.isfinite(d.qvel).all())
    return {"traj qpos": eq, "traj qvel": ev}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)    # six xdist workers share the CPU
    yield
    torch.set_num_threads(n)


def stage_bounds(scales):
    """BOUNDS with each of REL_BOUNDS in absolute units, from the stages'
    max |value| in `scales`."""
    return {**BOUNDS, **{k: u * EPS64 * scales[k]
                         for k, u in REL_BOUNDS.items()}}


def hold(errs, bounds=BOUNDS):
    over = {k: (v, bounds[k]) for k, v in errs.items() if not v <= bounds[k]}
    assert not over, over


def test_stages_match_jax_f64():
    """FK, CRB and bias, collide, `_make_rows_ref`, the non-fused Newton
    and noslip through inv(M), each on the JAX stage's inputs."""
    TKR.reset_launches()
    scales = {}
    errs = stage_errors(0, scales)
    hold(errs, stage_bounds(scales))
    assert all(n == 0 for n in TKR.launches.values())


def test_hammer_50_substeps_match_jax_f64():
    hold(trajectory_errors(0))


def test_f64_env_steps_all_tasks():
    """`envs.make(task, dtype=torch.float64)` resets and auto-reset steps
    every task on the CPU: float64 obs, finite, no quarantine."""
    from mj_envs_torch.parallel.vector import VectorEnv
    for task in TASKS:
        env = tenvs.make(task, device="cpu", dtype=torch.float64)
        venv = VectorEnv(env, 2, chunk_size=0)
        st = venv.reset(seed=1)
        a = torch.as_tensor(np.random.default_rng(1).uniform(
            -1.0, 1.0, (2, env.nu)))
        st = venv.step(st, a)
        assert st.obs.dtype == torch.float64 and st.reward.dtype == \
            torch.float64, task
        assert bool(torch.isfinite(st.obs).all()), task
        assert int(st.nan_resets.sum()) == 0, task
