"""The port's state API (`get_env_state`, `set_physics_state`) against the
JAX env, and NaN quarantine isolation (float32, CPU).

* `set_physics_state` on all four tasks: 4 envs from a JAX reset, carried
  into the port; both packages set the same seeded qpos0 + 0.05 N(0, 1),
  0.5 N(0, 1) and run `pipeline.forward`.  obs and sensordata at rtol
  1e-3 / atol 1e-3 and the caches FK writes at 1e-5, the bounds of
  `tests/test_torch_physics.py`; qacc and efc_force, which the float32
  Newton exit leaves at a cost-relative tolerance, within 1e-3 of the
  array's largest value.  `get_env_state` returns host copies of what
  was set, as the JAX env's.  Measured at seed 4 (`python
  tests/measure_torch_f64_floors.py env_state`, seeds 4-6): qacc at
  most 3.1e-5 of its scale (door), efc_force 2.0e-5; at seed 6 door's
  efc_force 2.3e-4, and pen's qacc 3.0e-2 of its scale, efc_force
  0.24: there the two packages' cylinder-box contacts differ in float64
  too (points up to 5.3e-2 apart, depths 7.2e-4).  Both compute the same
  thing; a tie in the box's support gradient, decided by the sign of a
  ~1e-18 rounding residue, sends the polish to another local maximum
  (`tests/test_torch_cylinder_box.py` shows the flip and its margin).
  Seed 4's bounds stay: the tie is a property of the reference.
* Quarantine, as `tests/test_env_api.py::test_nan_quarantine_vmapped_
  isolation` holds the JAX package: NaN in env 1's qvel of 4 hammer envs
  restarts env 1 alone, everything stays finite, the next step too, and
  envs 0, 2 and 3 are an unpoisoned run's bit for bit (the CPU path
  computes each env's rows, solves and sweeps apart from the others').
"""
import numpy as np
import pytest
import torch

import jax

from mj_envs_tpu import envs as jenvs
from mj_envs_torch import envs as tenvs
from mj_envs_torch.parallel.vector import VectorEnv
from test_torch_hammer import to_port

B = 4
TASKS = ("hammer-v0", "door-v0", "pen-v0", "relocate-v0")
FORWARD = dict(rtol=1e-3, atol=1e-3)
ELEM = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)    # six xdist workers share the CPU
    yield
    torch.set_num_threads(n)


def set_state_pair(task, seed):
    """Both packages' `set_physics_state` on B envs of `task` from a JAX
    reset, at qpos0 + 0.05 N(0, 1), qvel 0.5 N(0, 1) drawn from `seed`:
    (jenv, tenv, port state before, port out, JAX out, qpos, qvel)."""
    jenv = jenvs.make(task)
    tenv = tenvs.make(task, device="cpu")
    st_j = jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(seed), B))
    st_t = to_port(st_j)
    rng = np.random.default_rng(seed)
    qpos = (np.asarray(st_j.data.qpos)
            + 0.05 * rng.standard_normal((B, tenv.nq))).astype(np.float32)
    qvel = (0.5 * rng.standard_normal((B, tenv.nv))).astype(np.float32)
    out_j = jax.jit(jax.vmap(jenv.set_physics_state))(st_j, qpos, qvel)
    out_t = tenv.set_physics_state(st_t, qpos, qvel)
    return jenv, tenv, st_t, out_t, out_j, qpos, qvel


@pytest.mark.parametrize("task", TASKS)
def test_set_physics_state_matches_jax(task):
    jenv, tenv, st_t, out_t, out_j, qpos, qvel = set_state_pair(task, 4)
    got = tenv.get_env_state(out_t)
    want = jenv.get_env_state(out_j)
    for k in ("qpos", "qvel"):
        assert isinstance(got[k], np.ndarray) and got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
        np.testing.assert_array_equal(got[k], {"qpos": qpos,
                                               "qvel": qvel}[k], k)
    got["qpos"][:] = 0.0                       # a copy, not a view
    assert bool((out_t.data.qpos != 0).any())
    np.testing.assert_allclose(out_t.obs.numpy(), np.asarray(out_j.obs),
                               err_msg="obs", **FORWARD)
    np.testing.assert_allclose(out_t.data.sensordata.numpy(),
                               np.asarray(out_j.data.sensordata),
                               err_msg="sensordata", **FORWARD)
    for f in ("qacc", "efc_force"):
        want = np.asarray(getattr(out_j.data, f))
        np.testing.assert_allclose(getattr(out_t.data, f).numpy(), want,
                                   rtol=0, atol=1e-3 * np.abs(want).max(),
                                   err_msg=f)
    for f in ("xpos", "site_xpos", "geom_xmat", "subtree_com"):
        np.testing.assert_allclose(getattr(out_t.data, f).numpy(),
                                   np.asarray(getattr(out_j.data, f)),
                                   err_msg=f, **ELEM)
    # The state's bookkeeping is left alone.
    for f in ("step_count", "nan_resets", "done"):
        assert torch.equal(getattr(out_t, f), getattr(st_t, f)), f


def _hammer_step(poison):
    env = tenvs.make("hammer-v0", device="cpu")
    venv = VectorEnv(env, B, chunk_size=B)
    st = venv.reset(seed=2)
    if poison:
        qvel = st.data.qvel.clone()
        qvel[1, 0] = float("nan")
        st = st.replace(data=st.data.replace(qvel=qvel))
    a = torch.as_tensor(np.random.default_rng(2).uniform(
        -1.0, 1.0, (2, B, env.nu)).astype(np.float32))
    out = venv.step(st, a[0])
    return out, venv.step(out, a[1])


def test_nan_quarantine_isolates_one_env_of_four():
    out, nxt = _hammer_step(poison=True)
    assert out.nan_resets.tolist() == [0, 1, 0, 0]
    assert out.step_count.tolist() == [1, 0, 1, 1]
    assert out.done.tolist() == [False, True, False, False]
    assert float(out.reward[1]) == 0.0
    for t in (out.obs, out.data.qpos, out.data.qvel, out.reward,
              nxt.obs, nxt.data.qpos, nxt.data.qvel, nxt.reward):
        assert bool(torch.isfinite(t).all())
    assert nxt.nan_resets.tolist() == [0, 1, 0, 0]
    assert nxt.step_count.tolist() == [2, 1, 2, 2]

    ref, ref_nxt = _hammer_step(poison=False)
    keep = [0, 2, 3]
    for a, b in ((out, ref), (nxt, ref_nxt)):
        for f in ("obs", "reward", "final_obs", "step_count"):
            assert torch.equal(getattr(a, f)[keep], getattr(b, f)[keep]), f
        for f in ("qpos", "qvel", "qacc", "qacc_warmstart", "efc_force",
                  "sensordata"):
            assert torch.equal(getattr(a.data, f)[keep],
                               getattr(b.data, f)[keep]), f
