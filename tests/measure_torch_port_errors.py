"""Print the port's largest errors against the JAX package, stage by
stage, on the hammer states of `test_torch_physics.py`; FK on each
task's tree as `test_torch_fk.py` runs it; the sphere pair functions;
and the 8-env trajectory of `test_torch_hammer.py` for each of the four
tasks (float32, CPU).

The tests assert bounds; this prints the measured maxima behind them:

    JAX_PLATFORMS=cpu python tests/measure_torch_port_errors.py

(Not collected by pytest: the name does not start with `test_`.)
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import conftest  # noqa: E402,F401  (JAX on the CPU, x64 as in the tests)
import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_fk as TF  # noqa: E402
import test_torch_hammer as TH  # noqa: E402
import test_torch_physics as T  # noqa: E402

TASKS = ("hammer-v0", "door-v0", "pen-v0", "relocate-v0")


def report(name, got, want, mask=None):
    got = np.asarray(got.detach().numpy() if hasattr(got, "detach")
                     else got, np.float64)
    want = np.asarray(want, np.float64)
    if mask is not None:
        got, want = got[mask], want[mask]
    d = np.abs(got - want)
    print(f"{name:34s} max abs {d.max():.2e}   max |ref| "
          f"{np.abs(want).max():.2e}")


def stages():
    w = T.make_world()
    d, s = w["d"], w["jm"].spec
    jk = T.jkin(w)
    k = T.TK.kinematics(w["tm"], T.tt(d.qpos))
    report("kinematics (all fields)",
           np.concatenate([getattr(k, f).numpy().ravel()
                           for f in T.TK.Kin._fields]),
           np.concatenate([np.asarray(getattr(jk, f)).ravel()
                           for f in T.TK.Kin._fields]))

    con_j, _ = T.jcollide(w, w["ncmax"])
    con = T.TC.narrowphase_all(w["tm"], T.tkin(jk))
    act = np.asarray(con_j.active)
    report("narrowphase dist, in contact", con.dist, con_j.dist, act)
    d_t, d_j = con.dist.numpy(), np.asarray(con_j.dist)
    both = (d_t < T.TC.NP.BIG) & (d_j < T.TC.NP.BIG) & ~act
    report("narrowphase dist, out of contact", d_t, d_j, both)

    _, _, rows_j = T._rows(w)
    M_j, qs_j, fac_j = T._smooth_solve_inputs(w)
    res_j = jax.jit(jax.vmap(lambda M, qs, r, ws: T.JS.newton_solve(
        M, qs, r, ws, iterations=s.iterations)))(
            M_j, qs_j, rows_j, d.qacc_warmstart)
    res = T.TS.newton_solve(T.tt(M_j), T.tt(qs_j), T._trows(rows_j),
                            T.tt(d.qacc_warmstart), iterations=s.iterations)
    for f in ("qacc", "efc_force", "jar"):
        report(f"newton_solve {f}", getattr(res, f), getattr(res_j, f))

    nfl = int(np.sum(s.dof_hasfrictionloss))
    ns_j = jax.jit(jax.vmap(lambda M, r, rs, fac: T.JS.noslip(
        M, r, rs, nfl, w["ncmax"], s.noslip_iterations, M_fac=fac)))(
            M_j, rows_j, res_j, fac_j)
    ns = T.TS.noslip(T.tt(M_j), T._trows(rows_j),
                     T.TS.SolveResult(*(T.tt(x) for x in res_j)), nfl,
                     w["ncmax"], s.noslip_iterations, M_fac=T.tt(fac_j))
    for f in ("qacc", "efc_force", "jar"):
        report(f"noslip {f}", getattr(ns, f), getattr(ns_j, f))

    out_j = w["jstep"](w["var"], d, w["ctrl"])
    out = T.TP.step(w["tm"], T._tdata(d), T.tt(w["ctrl"]))
    for f in ("qpos", "qvel", "qacc", "sensordata", "efc_force"):
        report(f"pipeline.step {f}", getattr(out, f), getattr(out_j, f))


def fk(task):
    """FK of `test_torch_fk.py`: largest error over the Kin fields,
    shared and per-env model fields (its bound is 2e-5 * max(1, |x|))."""
    jm = TF.jenvs.make(task).model
    spec = TF.tenvs.make(task, device="cpu").spec
    rng = np.random.default_rng(3)
    qpos = (np.asarray(jm.qpos0)[None] + 0.3 * rng.standard_normal(
        (TF.B, spec.nq))).astype(np.float32)
    tm = TF.Model.from_numpy({n: np.asarray(getattr(jm, n))
                              for n in TF.Model.leaf_names()}, spec,
                             device="cpu")
    for label, fields in (("shared", {}), ("per-env", TF._per_env_fields(
            jm, TF.PER_ENV[task], rng))):
        fn = lambda f, q: TF.JK._kinematics_ref(jm.replace(**f), q)  # noqa
        k_j = jax.jit(jax.vmap(fn, in_axes=({k: 0 for k in fields}, 0)))(
            {k: jax.numpy.asarray(v) for k, v in fields.items()}, qpos)
        k_t = TF.TK.kinematics(tm.replace(**{k: torch.as_tensor(v) for k, v
                                             in fields.items()}),
                               torch.as_tensor(qpos))
        report(f"{task} fk, {label} fields",
               np.concatenate([getattr(k_t, f).numpy().ravel()
                               for f in TF.TK.Kin._fields]),
               np.concatenate([np.asarray(getattr(k_j, f)).ravel()
                               for f in TF.TK.Kin._fields]))


def sphere_pairs():
    """The five sphere pair functions on the random geometry of
    `test_torch_physics.py::test_sphere_pair_functions`."""
    import pytest
    for name in ("plane_sphere", "sphere_sphere", "sphere_capsule",
                 "sphere_cylinder", "sphere_box"):
        got = {}

        def close(t, j, err_msg="", **tol):
            got[err_msg.split()[-1]] = (t, j)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(T, "close", close)
            T.test_sphere_pair_functions(name)
        for f, (t, j) in got.items():
            report(f"{name} {f}", t, j)


def trajectory(task):
    """`test_torch_hammer.py`'s 8-env auto-reset trajectory for `task`:
    the largest error over its steps."""
    jenv = TH.jenvs.make(task)
    jv = TH.JVectorEnv(jenv, TH.N, chunk_size=TH.CHUNK)
    tenv = TH.tenvs.make(task, device="cpu")
    tv = TH.VectorEnv(tenv, TH.N, chunk_size=TH.CHUNK)
    tv.reset(seed=0)
    st_j = jax.jit(jv.reset)(jax.random.PRNGKey(0))
    st_t = TH.to_port(st_j)
    step = jax.jit(jv.step)
    rng = np.random.default_rng(0)
    got = {f: [] for f in ("qpos", "qvel", "obs", "reward")}
    for _ in range(TH.STEPS):
        a = rng.uniform(-1.0, 1.0, (TH.N, tenv.nu)).astype(np.float32)
        st_j = step(st_j, a)
        st_t = tv.step(st_t, torch.as_tensor(a))
        for f in got:
            src_t = st_t.data if f in ("qpos", "qvel") else st_t
            src_j = st_j.data if f in ("qpos", "qvel") else st_j
            got[f].append((getattr(src_t, f), getattr(src_j, f)))
    for f, pairs in got.items():
        report(f"{task} {TH.STEPS} env steps {f}",
               torch.stack([t for t, _ in pairs]),
               np.stack([np.asarray(j) for _, j in pairs]))


if __name__ == "__main__":
    torch.set_num_threads(4)
    stages()
    sphere_pairs()
    for task in TASKS:
        fk(task)
        trajectory(task)
