"""The port's door-v0 batched env step, as a whole, against the JAX
package (float32, CPU).

As `tests/test_torch_hammer.py`: 8 envs stepped with auto-reset in
chunks of 4, the JAX reset states carried into the port through
`EnvState.from_numpy`, the same numpy actions on both sides, rtol 1e-3 /
atol 2e-3 on the float fields and the flags and counters exact.  door
runs one physics substep per env step.
"""
import numpy as np
import torch

from mj_envs_torch import envs as tenvs
from mj_envs_torch.parallel.vector import VectorEnv
from test_torch_hammer import (check_auto_reset_steps, check_trajectory,
                               task_pair)

envs_pair = task_pair("door-v0")


def test_auto_reset_steps_match_jax(envs_pair):
    assert envs_pair["tenv"].FRAME_SKIP == 1
    check_auto_reset_steps(envs_pair)


# 50 substeps = 50 env steps.  Measured worst over seeds 0-2 (max abs):
# qpos 2.5e-6, qvel 1.7e-4, obs 2.5e-6.
TRAJ_BOUNDS = {"qpos": 6e-6, "qvel": 4e-4, "obs": 6e-6}


def test_50_substep_trajectory_matches_jax(envs_pair):
    check_trajectory(envs_pair, TRAJ_BOUNDS)


def test_reset_distribution():
    """The port's own resets: the door frame's position uniform in
    x [-0.3, -0.2], y [0.25, 0.35], z [0.252, 0.35] (door_v0.py:103-118),
    everything else at the model's values."""
    env = tenvs.make("door-v0", device="cpu")
    st = VectorEnv(env, 256, chunk_size=64).reset(seed=7)
    bid = env.door_bid
    pos = st.var.body_pos[:, bid]
    for axis, (lo, hi) in enumerate(((-0.3, -0.2), (0.25, 0.35),
                                     (0.252, 0.35))):
        x = pos[:, axis]
        assert bool(((x >= lo) & (x <= hi)).all()), axis
        assert x.std() > 0.2 * (hi - lo), axis      # uniform: sd 0.29 (hi-lo)
    others = torch.ones(env.spec.nbody, dtype=torch.bool)
    others[bid] = False
    assert torch.equal(st.var.body_pos[:, others],
                       env.model.body_pos[others].expand(256, -1, -1))
    assert torch.equal(st.data.qpos, env.model.qpos0.expand(256, -1))
    assert bool(torch.isfinite(st.obs).all())
    assert st.obs.shape == (256, env.OBS_DIM) == (256, 39)
    # The handle moves with the frame (obs 32:35 is the handle position).
    corr = torch.corrcoef(torch.stack([st.obs[:, 32], pos[:, 0]]))[0, 1]
    assert float(corr) > 0.99


def test_evaluate_success_matches_jax(envs_pair):
    """% of paths with more than 25 successful steps, as the JAX env."""
    paths = np.random.default_rng(3).uniform(size=(16, 60)) > 0.5
    got = envs_pair["tenv"].evaluate_success(paths)
    assert got == envs_pair["jenv"].evaluate_success(paths)
    assert 0.0 < got < 100.0
