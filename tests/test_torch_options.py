"""The port's FK and constraint-layout options against the JAX package
(float32, CPU), and the rule that the float64 path ignores every knob.

* ``MJE_FK_IMPL=parallel``: `kinematics_parallel` against the JAX
  `_kinematics_parallel` and against `kinematics_plain`, on all four
  trees, with every model field shared and with the task's per-env
  fields; tolerance 2e-5 * max(1, |x|) per field, the JAX package's own
  for its parallel FK against the sequential one
  (`tests/test_kernels.py::test_fk_parallel_matches_ref`).
* ``MJE_JBASE=1``: the base-compressed rows and their four consumers
  (`j_matvec`, `jt_matvec`, `jtwj`, `expand_J`) against the JAX
  package's on the hammer states of `tests/test_torch_physics.py`, at
  its elementwise bounds; a whole substep at its solver bounds against a
  JAX substep traced after the variable was set.
* The knobs are read on every call, as the JAX package reads them when
  it traces; the float64 results are the same bits with all five set.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mj_envs_tpu import envs as jenvs
from mj_envs_tpu.envs.base import _apply_var as j_apply_var
from mj_envs_tpu.physics import constraint as JCN
from mj_envs_tpu.physics import kinematics as JK
from mj_envs_tpu.physics import pipeline as JP
from mj_envs_torch import envs as tenvs
from mj_envs_torch.physics import constraint as TCN
from mj_envs_torch.physics import kinematics as TK
from mj_envs_torch.physics import pipeline as TP
from mj_envs_torch.physics.collision import driver as TC
from mj_envs_torch.physics.model import Data, Model
from test_torch_fk import PER_ENV, _assert_kin_close, _per_env_fields
from test_torch_physics import (NOSLIP, _tdata, close, jcollide, jkin,
                                jvmap, make_world, tt)

KNOBS = {"MJE_NEWTON_TOL_SCALE": "1e5", "MJE_NOSLIP_TOL": "0.5",
         "MJE_FK_IMPL": "parallel", "MJE_JBASE": "1",
         "MJE_NO_FK_KERNEL": "1"}


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def world():
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)   # six xdist workers share the CPU
    yield make_world()
    torch.set_num_threads(n_threads)


@pytest.mark.parametrize("task", sorted(PER_ENV))
def test_kinematics_parallel_matches_jax(task):
    # The JAX package keys its parallel-FK tables by id(spec): an entry
    # left by a spec that an earlier test freed would be read by a new
    # spec at the same address (another task's tables), so start empty.
    JK._FK_PAR_STATIC.clear()
    jm = jenvs.make(task).model
    spec = tenvs.make(task, device="cpu").spec
    rng = np.random.default_rng(3)
    qpos = (np.asarray(jm.qpos0)[None] + 0.3 * rng.standard_normal(
        (8, spec.nq))).astype(np.float32)
    tm = Model.from_numpy({n: np.asarray(getattr(jm, n))
                           for n in Model.leaf_names()}, spec, device="cpu")
    per_env = _per_env_fields(jm, PER_ENV[task], rng)
    # Both packages' parallel FK take the world body's offset as the
    # identity (no task varies it), the sequential one never reads it.
    for name in ("body_pos", "body_quat"):
        if name in per_env:
            per_env[name][:, 0] = np.asarray(getattr(jm, name))[0]
    for fields in ({}, per_env):
        fn = lambda f, q: JK._kinematics_parallel(jm.replace(**f), q)  # noqa
        k_j = jax.jit(jax.vmap(fn, in_axes=({k: 0 for k in fields}, 0)))(
            {k: jnp.asarray(v) for k, v in fields.items()},
            jnp.asarray(qpos))
        m = tm.replace(**{k: torch.as_tensor(v) for k, v in fields.items()})
        q = torch.as_tensor(qpos)
        k_t = TK.kinematics_parallel(m, q)
        label = f"{task} per-env {sorted(fields)}"
        _assert_kin_close(k_t, k_j, label)
        _assert_kin_close(k_t, TK.kinematics_plain(m, q), label + " plain")


def test_fk_knobs_read_on_every_call(monkeypatch):
    """`kinematics` picks its FK by MJE_FK_IMPL and MJE_NO_FK_KERNEL at
    each call, with the JAX package's meanings; float64 is always ref."""
    env = tenvs.make("door-v0", device="cpu")
    q = env.model.qpos0[None].expand(2, -1).clone()
    ran = []
    for name in ("kinematics_parallel", "kinematics_plain"):
        fn = getattr(TK, name)
        monkeypatch.setattr(TK, name, lambda m, x, fn=fn, name=name: (
            ran.append(name), fn(m, x))[1])
    cases = [({}, "pallas", "kinematics_plain"),
             ({"MJE_FK_IMPL": "parallel"}, "parallel", "kinematics_parallel"),
             ({"MJE_FK_IMPL": "ref"}, "ref", "kinematics_plain"),
             ({"MJE_NO_FK_KERNEL": "1"}, "ref", "kinematics_plain"),
             ({"MJE_FK_IMPL": "parallel", "MJE_NO_FK_KERNEL": "1"},
              "parallel", "kinematics_parallel"),
             ({}, "pallas", "kinematics_plain")]
    for env_vars, impl, fn in cases:
        for k in ("MJE_FK_IMPL", "MJE_NO_FK_KERNEL"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env_vars.items():
            monkeypatch.setenv(k, v)
        assert TK.fk_impl() == impl, env_vars
        assert TK.fk_impl(torch.float64) == "ref", env_vars
        ran.clear()
        TK.kinematics(env.model, q)
        assert ran == [fn], env_vars
        ran.clear()
        TK.kinematics(env.model.replace(**{
            f: getattr(env.model, f).double()
            for f in Model.leaf_names()
            if getattr(env.model, f).is_floating_point()}), q.double())
        assert ran == ["kinematics_plain"], env_vars


def _jax_rows(world, monkeypatch, jbase):
    """The JAX rows of the world states, traced afresh with MJE_JBASE."""
    d = world["d"]
    jk = jkin(world)
    _, cc_j = jcollide(world, world["ncmax"])
    if jbase:
        monkeypatch.setenv("MJE_JBASE", "1")
    rows_j = jvmap(world, JCN.make_rows)(world["var"], jk, d.qpos, d.qvel,
                                         cc_j)
    monkeypatch.delenv("MJE_JBASE", raising=False)
    return jk, cc_j, rows_j


def _trows(rows_j):
    return TCN.Rows(**{f: None if getattr(rows_j, f) is None
                       else tt(getattr(rows_j, f)) for f in TCN.Rows._fields})


def test_jbase_rows_and_consumers_match_jax(world, monkeypatch):
    """make_rows under MJE_JBASE=1 against the JAX package's (J holds the
    104 non-contact rows, Jbase 32 x 4 base rows), and the four
    consumers on the JAX rows against the JAX consumers: J x, J^T f,
    J^T diag(w) J and the expanded J, which equals the dense default."""
    jk, cc_j, rows_j = _jax_rows(world, monkeypatch, jbase=True)
    _, _, dense_j = _jax_rows(world, monkeypatch, jbase=False)
    assert rows_j.Jbase is not None and dense_j.Jbase is None
    cc = TC.CompactContacts(**{f: tt(getattr(cc_j, f))
                               for f in TC.CompactContacts._fields})
    d = world["d"]
    kin = TK.Kin(**{f: tt(getattr(jk, f)) for f in TK.Kin._fields})
    args = (world["tm"], kin, tt(d.qpos), tt(d.qvel), cc)
    monkeypatch.setenv("MJE_JBASE", "1")
    rows = TCN.make_rows(*args)
    monkeypatch.delenv("MJE_JBASE")
    dense = TCN.make_rows(*args)
    assert rows.J.shape == (6, 104, 33) and rows.Jbase.shape == (6, 128, 33)
    assert dense.Jbase is None and dense.J.shape == (6, 296, 33)
    for f in ("active", "oneside"):
        np.testing.assert_array_equal(getattr(rows, f).numpy(),
                                      np.asarray(getattr(rows_j, f)), f)
    for f in ("J", "Jbase", "aref", "R", "D", "floss", "pos"):
        close(getattr(rows, f), getattr(rows_j, f), f)

    rng = np.random.default_rng(6)
    B, nefc, nv = 6, 296, 33
    x = rng.standard_normal((B, nv)).astype(np.float32)
    f = rng.standard_normal((B, nefc)).astype(np.float32)
    w = rng.uniform(0.0, 2.0, (B, nefc)).astype(np.float32)
    rt = _trows(rows_j)
    want = jax.jit(jax.vmap(lambda r, x, f, w: (
        JCN.j_matvec(r, x), JCN.jt_matvec(r, f), JCN.jtwj(r, w),
        JCN.expand_J(r))))(rows_j, x, f, w)
    got = (TCN.j_matvec(rt, tt(x)), TCN.jt_matvec(rt, tt(f)),
           TCN.jtwj(rt, tt(w)), TCN.expand_J(rt))
    for name, g, j in zip(("j_matvec", "jt_matvec", "jtwj", "expand_J"),
                          got, want):
        close(g, j, name)
    close(TCN.expand_J(rows), dense.J, "expand_J vs the dense rows")


def test_forward_core_jbase_matches_jax(world, monkeypatch):
    """A substep with MJE_JBASE=1: forward_core keeps the compressed
    rows through the solver and noslip, and the step matches a JAX step
    traced with the variable set, at test_forward_core_and_step's
    bounds."""
    d_j = world["d"]
    m = world["tm"]
    d = _tdata(d_j)
    ctrl = tt(world["ctrl"])
    monkeypatch.setenv("MJE_JBASE", "1")
    fo = TP.forward_core(m, d.qpos, d.qvel, ctrl, d.qacc_warmstart,
                         d.qfrc_applied)
    assert fo.rows.Jbase is not None
    out = TP.step(m, d, ctrl)
    jm = world["jm"]
    out_j = jax.jit(jax.vmap(lambda var, dd, c: JP.step(
        j_apply_var(jm, var), dd, c)))(world["var"], d_j, world["ctrl"])
    for f in ("qacc", "efc_force", "sensordata"):
        close(getattr(out, f), getattr(out_j, f), f, **NOSLIP)
    for f in ("qpos", "qvel"):
        close(getattr(out, f), getattr(out_j, f), f)
    close(fo.qacc, out_j.qacc, "forward_core qacc", **NOSLIP)


def test_jbase_read_on_every_call(world, monkeypatch):
    """make_rows reads MJE_JBASE at each call."""
    jk, cc_j, _ = _jax_rows(world, monkeypatch, jbase=False)
    cc = TC.CompactContacts(**{f: tt(getattr(cc_j, f))
                               for f in TC.CompactContacts._fields})
    kin = TK.Kin(**{f: tt(getattr(jk, f)) for f in TK.Kin._fields})
    d = world["d"]
    args = (world["tm"], kin, tt(d.qpos), tt(d.qvel), cc)
    for value, compressed in (("1", True), ("0", False), ("1", True)):
        monkeypatch.setenv("MJE_JBASE", value)
        assert (TCN.make_rows(*args).Jbase is not None) == compressed
    # float64 runs the dense oracle-parity rows whatever the knob says.
    f64 = [x.double() if x.is_floating_point() else x for x in args[2:4]]
    m64 = world["tm"].replace(**{
        f: getattr(world["tm"], f).double() for f in Model.leaf_names()
        if getattr(world["tm"], f).is_floating_point()})
    kin64 = TK.Kin(*(t.double() for t in kin))
    cc64 = TC.CompactContacts(*(t.double() if t.is_floating_point() else t
                                for t in cc))
    assert TCN.make_rows(m64, kin64, *f64, cc64).Jbase is None


def test_f64_results_ignore_every_knob(monkeypatch):
    """float64 forward_core and step on hammer: the same bits with all
    five knobs set as with none (USAGE.md: the knobs act on the float32
    path only)."""
    torch.set_num_threads(1)
    env = tenvs.make("hammer-v0", device="cpu", dtype=torch.float64)
    from mj_envs_torch.parallel.vector import VectorEnv
    venv = VectorEnv(env, 3, chunk_size=0)
    st = venv.reset(seed=2)
    a = torch.as_tensor(np.random.default_rng(2).uniform(
        -1.0, 1.0, (3, env.nu)))
    st = venv.step(st, a)                    # a state with momentum
    from mj_envs_torch.envs.base import _apply_var
    m = _apply_var(env.model, st.var)
    d = st.data
    ctrl = env.act_mid + a * env.act_rng

    def run():
        fo = TP.forward_core(m, d.qpos, d.qvel, ctrl, d.qacc_warmstart,
                             d.qfrc_applied)
        return fo, TP.step(m, d, ctrl)

    fo0, out0 = run()
    for k, v in KNOBS.items():
        monkeypatch.setenv(k, v)
    fo1, out1 = run()
    assert fo1.rows.Jbase is None
    for f in ("qacc", "sensordata", "qacc_smooth"):
        assert torch.equal(getattr(fo0, f), getattr(fo1, f)), f
    for f in Data.field_names():
        assert torch.equal(getattr(out0, f), getattr(out1, f)), f
