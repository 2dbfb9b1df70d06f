"""Print the port's largest errors against the JAX package, stage by
stage, on the hammer states of `test_torch_physics.py` and the 8-env
trajectory of `test_torch_hammer.py` (float32, CPU).

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

import test_torch_hammer as TH  # noqa: E402
import test_torch_physics as T  # noqa: E402


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


def trajectory():
    jenv = TH.jenvs.make("hammer-v0")
    jv = TH.JVectorEnv(jenv, TH.N, chunk_size=TH.CHUNK)
    tenv = TH.tenvs.make("hammer-v0", device="cpu")
    tv = TH.VectorEnv(tenv, TH.N, chunk_size=TH.CHUNK)
    tv.reset(seed=0)
    st_j = jax.jit(jv.reset)(jax.random.PRNGKey(0))
    st_t = TH.to_port(st_j)
    step = jax.jit(jv.step)
    rng = np.random.default_rng(0)
    for i in range(TH.STEPS):
        a = rng.uniform(-1.0, 1.0, (TH.N, tenv.nu)).astype(np.float32)
        st_j = step(st_j, a)
        st_t = tv.step(st_t, torch.as_tensor(a))
        for f in ("qpos", "qvel"):
            report(f"env step {i + 1} {f}", getattr(st_t.data, f),
                   getattr(st_j.data, f))
        for f in ("obs", "reward"):
            report(f"env step {i + 1} {f}", getattr(st_t, f),
                   getattr(st_j, f))


if __name__ == "__main__":
    torch.set_num_threads(4)
    stages()
    trajectory()
