"""The port's pen-v0 batched env step, as a whole, against the JAX
package (float32, CPU).

As `tests/test_torch_hammer.py`: 8 envs stepped with auto-reset in
chunks of 4, the JAX reset states carried into the port through
`EnvState.from_numpy`, the same numpy actions on both sides, rtol 1e-3 /
atol 2e-3 on the float fields and the flags and counters exact.  pen is
the one task that terminates (the pen dropped below z = 0.075), and its
reset draws the target orientation through `quatmath.euler2quat`.
"""
import numpy as np
import torch

import jax.numpy as jnp

from mj_envs_tpu.utils import quatmath as JQ
from mj_envs_torch import envs as tenvs
from mj_envs_torch.parallel.vector import VectorEnv
from mj_envs_torch.physics import kinematics as K
from mj_envs_torch.physics.model import JNT_SLIDE
from mj_envs_torch.utils import quatmath as Q
from test_torch_hammer import (N, check_auto_reset_steps, check_trajectory,
                               compare, task_pair, to_port)

envs_pair = task_pair("pen-v0")


def test_auto_reset_steps_match_jax(envs_pair):
    check_auto_reset_steps(envs_pair)


# 50 substeps = 10 env steps.  Measured worst over seeds 0-2 (max abs):
# qpos 7.3e-4, qvel 1.3e-1, obs 1.3e-1 (obs carries qvel).  pen's
# in-hand grasp is the contact-richest scene: the JAX package's own
# float64 trajectory drifts 2.7e-3 / 0.13 from mujoco over 50 substeps
# (`tests/test_step_parity.py`).
TRAJ_BOUNDS = {"qpos": 2e-3, "qvel": 0.4, "obs": 0.4}


def test_50_substep_trajectory_matches_jax(envs_pair):
    check_trajectory(envs_pair, TRAJ_BOUNDS)


def test_dropped_terminates_and_resets(envs_pair):
    """Envs whose pen is moved below the drop height terminate: done, not
    truncated, reward with the -5 drop term, the finishing step's obs in
    final_obs, a fresh episode at qpos0 in the state.  The fresh
    episodes' random targets differ between the packages, so obs is
    compared on the envs that carry on."""
    p = envs_pair
    env = p["tenv"]
    s = env.spec
    # The pen's slide joint that moves it most along world z at qpos0.
    k = K.kinematics(env.model, env.model.qpos0[None])
    slides = [j for j in range(s.njnt - 6, s.njnt)
              if int(s.jnt_type[j]) == JNT_SLIDE]
    j = max(slides, key=lambda j: abs(float(k.xaxis[0, j, 2])))
    drop = np.arange(N) % 2 == 0
    qpos = np.array(p["jst0"].data.qpos)
    qpos[drop, j] -= 0.3 * np.sign(float(k.xaxis[0, j, 2]))
    st_j = p["jst0"].replace(data=p["jst0"].data.replace(
        qpos=jnp.asarray(qpos)))
    st_t = to_port(st_j)
    a = np.random.default_rng(1).uniform(
        -1.0, 1.0, (N, env.nu)).astype(np.float32)
    st_j = p["jstep"](st_j, a)
    st_t = p["tv"].step(st_t, torch.as_tensor(a))
    np.testing.assert_array_equal(st_t.done.numpy(), drop)
    assert not st_t.truncated.any()
    np.testing.assert_array_equal(st_t.step_count.numpy(),
                                  np.where(drop, 0, 1))
    compare(st_t, st_j, fields=("obs",), rows=~drop)
    compare(st_t, st_j, fields=("reward", "final_obs"))
    assert bool((st_t.reward[torch.as_tensor(drop)] < -4.0).all())
    torch.testing.assert_close(st_t.data.qpos[drop],
                               env.model.qpos0.expand(int(drop.sum()), -1))
    assert not st_t.data.qvel[drop].any()


def test_euler2quat_matches_jax():
    e = np.random.default_rng(2).uniform(-3.0, 3.0, (64, 3)).astype(
        np.float32)
    np.testing.assert_allclose(Q.euler2quat(torch.as_tensor(e)).numpy(),
                               np.asarray(JQ.euler2quat(jnp.asarray(e))),
                               rtol=1e-6, atol=1e-6)


def test_reset_distribution():
    """The port's own resets (pen_v0.py:115-123): the target's body_quat
    is euler2quat of (x, y, 0) with x, y uniform in [-1, 1]; everything
    else at the model's values."""
    env = tenvs.make("pen-v0", device="cpu")
    st = VectorEnv(env, 256, chunk_size=64).reset(seed=7)
    bid = env.target_obj_bid
    quat = st.var.body_quat[:, bid]
    torch.testing.assert_close(quat.norm(dim=-1), torch.ones(256))
    euler = Q.quat2euler(quat)
    torch.testing.assert_close(Q.euler2quat(euler), quat, rtol=0, atol=1e-5)
    for axis in (0, 1):
        x = euler[:, axis]
        assert bool(((x >= -1.0 - 1e-5) & (x <= 1.0 + 1e-5)).all()), axis
        assert x.std() > 0.4, axis                 # uniform: sd 0.58
    assert float(euler[:, 2].abs().max()) < 1e-5
    others = torch.ones(env.spec.nbody, dtype=torch.bool)
    others[bid] = False
    assert torch.equal(st.var.body_quat[:, others],
                       env.model.body_quat[others].expand(256, -1, -1))
    assert torch.equal(st.data.qpos, env.model.qpos0.expand(256, -1))
    assert bool(torch.isfinite(st.obs).all())
    assert st.obs.shape == (256, env.OBS_DIM) == (256, 45)


def test_evaluate_success_matches_jax(envs_pair):
    """% of paths with more than 20 successful steps, as the JAX env."""
    paths = np.random.default_rng(3).uniform(size=(16, 40)) > 0.5
    got = envs_pair["tenv"].evaluate_success(paths)
    assert got == envs_pair["jenv"].evaluate_success(paths)
    assert 0.0 < got < 100.0
