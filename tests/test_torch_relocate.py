"""The port's relocate-v0 batched env step, as a whole, against the JAX
package (float32, CPU).

As `tests/test_torch_hammer.py`: 8 envs stepped with auto-reset in
chunks of 4, the JAX reset states carried into the port through
`EnvState.from_numpy`, the same numpy actions on both sides, rtol 1e-3 /
atol 2e-3 on the float fields and the flags and counters exact.
relocate's scene holds the sphere pair types (plane-sphere,
sphere-capsule, sphere-box) and varies body_pos and site_pos per env.
"""
import numpy as np
import torch

from mj_envs_torch import envs as tenvs
from mj_envs_torch.parallel.vector import VectorEnv
from mj_envs_torch.physics.collision import driver as TC
from test_torch_hammer import (check_auto_reset_steps, check_trajectory,
                               task_pair)

envs_pair = task_pair("relocate-v0")


def test_auto_reset_steps_match_jax(envs_pair):
    s = envs_pair["tenv"].spec
    sphere = TC.GEOM_SPHERE
    assert {key for key, _ in TC._groups(s)} >= {
        (TC.GEOM_PLANE, sphere), (sphere, TC.GEOM_CAPSULE),
        (sphere, TC.GEOM_BOX)}
    check_auto_reset_steps(envs_pair)


# 50 substeps = 10 env steps.  Measured worst over seeds 0-2 (max abs):
# qpos 4.5e-5, qvel 2.3e-3, obs 4.5e-5.
TRAJ_BOUNDS = {"qpos": 1e-4, "qvel": 5e-3, "obs": 1e-4}


def test_50_substep_trajectory_matches_jax(envs_pair):
    check_trajectory(envs_pair, TRAJ_BOUNDS)


def test_reset_distribution():
    """The port's own resets (relocate_v0.py:85-94): the ball's x in
    [-0.15, 0.15] and y in [-0.15, 0.3]; the target site's x, y in
    [-0.2, 0.2] and z in [0.15, 0.35]; everything else at the model's
    values."""
    env = tenvs.make("relocate-v0", device="cpu")
    st = VectorEnv(env, 256, chunk_size=64).reset(seed=7)
    bid, sid = env.obj_bid, env.target_obj_sid
    draws = [(st.var.body_pos[:, bid, 0], -0.15, 0.15),
             (st.var.body_pos[:, bid, 1], -0.15, 0.3),
             (st.var.site_pos[:, sid, 0], -0.2, 0.2),
             (st.var.site_pos[:, sid, 1], -0.2, 0.2),
             (st.var.site_pos[:, sid, 2], 0.15, 0.35)]
    for i, (x, lo, hi) in enumerate(draws):
        assert bool(((x >= lo) & (x <= hi)).all()), i
        assert x.std() > 0.2 * (hi - lo), i        # uniform: sd 0.29 (hi-lo)
    kept = torch.ones(env.spec.nbody, 3, dtype=torch.bool)
    kept[bid, :2] = False
    assert torch.equal(st.var.body_pos[:, kept],
                       env.model.body_pos[kept].expand(256, -1))
    kept = torch.ones(env.spec.nsite, dtype=torch.bool)
    kept[sid] = False
    assert torch.equal(st.var.site_pos[:, kept],
                       env.model.site_pos[kept].expand(256, -1, -1))
    assert torch.equal(st.data.qpos, env.model.qpos0.expand(256, -1))
    assert bool(torch.isfinite(st.obs).all())
    assert st.obs.shape == (256, env.OBS_DIM) == (256, 39)
    # obs ends with obj_pos - target_pos.
    torch.testing.assert_close(st.obs[:, -3:],
                               st.data.xpos[:, bid] - st.data.site_xpos[:, sid])


def test_evaluate_success_matches_jax(envs_pair):
    """% of paths with more than 25 successful steps, as the JAX env."""
    paths = np.random.default_rng(3).uniform(size=(16, 60)) > 0.5
    got = envs_pair["tenv"].evaluate_success(paths)
    assert got == envs_pair["jenv"].evaluate_success(paths)
    assert 0.0 < got < 100.0
