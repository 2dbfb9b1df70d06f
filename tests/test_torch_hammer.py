"""The port's hammer-v0 batched env step, as a whole, against the JAX
package (float32, CPU).

8 envs stepped with auto-reset in chunks of 4 on both sides.  Torch
cannot reproduce `jax.random` streams, so the JAX `VectorEnv.reset`
states go into the port through `EnvState.from_numpy`, both sides get
the same numpy actions, and the port's own reset distribution is held
to its bounds.  Tolerance: rtol 1e-3 / atol 2e-3 on the float fields,
the JAX package's own floor for "same math, different schedule"
(`tests/test_env_api.py`); the counters and flags match exactly.
"""
import numpy as np
import pytest
import torch

import jax

from mj_envs_tpu import envs as jenvs
from mj_envs_tpu.parallel.vector import VectorEnv as JVectorEnv
from mj_envs_torch import envs as tenvs
from mj_envs_torch.envs.base import EnvState
from mj_envs_torch.parallel.vector import VectorEnv

N, CHUNK, STEPS = 8, 4, 3
TOL = dict(rtol=1e-3, atol=2e-3)
EXACT = ("done", "truncated", "nan_resets", "contact_clips", "step_count",
         "goal_achieved")


def to_port(st) -> EnvState:
    """A JAX EnvState as the port's (its PRNG key has no counterpart)."""
    data = {f: np.asarray(getattr(st.data, f))
            for f in st.data.__dataclass_fields__}
    var = {f: np.asarray(getattr(st.var, f))
           for f in st.var.__dataclass_fields__
           if getattr(st.var, f) is not None}
    return EnvState.from_numpy(
        data, var, device="cpu",
        **{f: np.asarray(getattr(st, f)) for f in EnvState.LEAVES})


@pytest.fixture(scope="module")
def envs_pair():
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)   # six xdist workers share the CPU
    jenv = jenvs.make("hammer-v0")
    jv = JVectorEnv(jenv, N, chunk_size=CHUNK)
    tenv = tenvs.make("hammer-v0", device="cpu")
    tv = VectorEnv(tenv, N, chunk_size=CHUNK)
    tv.reset(seed=0)           # seeds the port's reset generator
    yield dict(jenv=jenv, jst0=jax.jit(jv.reset)(jax.random.PRNGKey(0)),
               jstep=jax.jit(jv.step), tenv=tenv, tv=tv)
    torch.set_num_threads(n_threads)


def compare(st_t, st_j, fields=("obs", "reward", "final_obs"), rows=None):
    rows = slice(None) if rows is None else rows
    for f in ("qpos", "qvel"):
        np.testing.assert_allclose(getattr(st_t.data, f).numpy(),
                                   np.asarray(getattr(st_j.data, f)),
                                   err_msg=f, **TOL)
    for f in fields:
        np.testing.assert_allclose(getattr(st_t, f).numpy()[rows],
                                   np.asarray(getattr(st_j, f))[rows],
                                   err_msg=f, **TOL)
    for f in EXACT:
        np.testing.assert_array_equal(getattr(st_t, f).numpy(),
                                      np.asarray(getattr(st_j, f)), f)


def test_auto_reset_steps_match_jax(envs_pair):
    p = envs_pair
    st_j = p["jst0"]
    st_t = to_port(st_j)
    compare(st_t, st_j)
    rng = np.random.default_rng(0)
    for _ in range(STEPS):
        a = rng.uniform(-1.0, 1.0, (N, p["tenv"].nu)).astype(np.float32)
        st_j = p["jstep"](st_j, a)
        st_t = p["tv"].step(st_t, torch.as_tensor(a))
        compare(st_t, st_j)
    assert st_t.obs.shape == (N, p["tenv"].OBS_DIM)
    assert not st_t.done.any()
    np.testing.assert_array_equal(st_t.step_count.numpy(), STEPS)


def test_truncation_at_episode_cap(envs_pair):
    """Envs at step_count 199 hit the 200-step cap: done and truncated,
    the finishing step's obs in final_obs, a fresh episode in the state.
    The fresh episodes' random board heights differ between the packages,
    so obs is compared on the envs that carry on."""
    p = envs_pair
    cap = p["tenv"].MAX_EPISODE_STEPS
    sc = np.where(np.arange(N) % 2 == 0, cap - 1, 5).astype(np.int32)
    st_j = p["jst0"].replace(step_count=jax.numpy.asarray(sc))
    st_t = to_port(st_j)
    a = np.random.default_rng(1).uniform(
        -1.0, 1.0, (N, p["tenv"].nu)).astype(np.float32)
    st_j = p["jstep"](st_j, a)
    st_t = p["tv"].step(st_t, torch.as_tensor(a))
    at_cap = sc == cap - 1
    np.testing.assert_array_equal(st_t.truncated.numpy(), at_cap)
    np.testing.assert_array_equal(st_t.done.numpy(), at_cap)
    np.testing.assert_array_equal(st_t.step_count.numpy(),
                                  np.where(at_cap, 0, 6))
    compare(st_t, st_j, fields=("obs",), rows=~at_cap)
    compare(st_t, st_j, fields=("reward", "final_obs"))
    # The fresh episodes start at qpos0 at rest.
    m = p["tenv"].model
    torch.testing.assert_close(st_t.data.qpos[at_cap],
                               m.qpos0.expand(int(at_cap.sum()), -1))
    assert not st_t.data.qvel[at_cap].any()


def test_reset_distribution():
    """The port's own resets: board height uniform in [0.1, 0.25]
    (hammer's randomization), everything else at the model's values."""
    env = tenvs.make("hammer-v0", device="cpu")
    st = VectorEnv(env, 256, chunk_size=64).reset(seed=7)
    bid = env.board_bid
    z = st.var.body_pos[:, bid, 2]
    assert bool(((z >= 0.1) & (z <= 0.25)).all())
    assert z.std() > 0.03                       # uniform: sd 0.043
    others = torch.ones(env.spec.nbody, 3, dtype=torch.bool)
    others[bid, 2] = False
    assert torch.equal(st.var.body_pos[:, others],
                       env.model.body_pos[others].expand(256, -1))
    assert torch.equal(st.data.qpos, env.model.qpos0.expand(256, -1))
    assert bool(torch.isfinite(st.obs).all())
    assert st.obs.shape == (256, env.OBS_DIM)
    # The board's target site moves with the board.
    tz = st.obs[:, -4 + 2]
    assert float(torch.corrcoef(torch.stack([tz, z]))[0, 1]) > 0.99


@pytest.mark.parametrize("variation", ["mass", "pos", "size"])
def test_variation_resets_and_steps(variation):
    """hammer's optional reset variations: each draws its fields in the
    reference's ranges per env, and the per-env fields step finitely."""
    env = tenvs.make("hammer-v0", variation_type=variation, device="cpu")
    venv = VectorEnv(env, 8, chunk_size=8)
    st = venv.reset(seed=11)
    head, neck, obj = env.head_gid, env.neck_gid, env.obj_bid
    if variation == "mass":
        x = st.var.body_mass[:, obj]
        assert bool(((x >= 0.05) & (x <= 2.5)).all())
        torch.testing.assert_close(st.var.geom_rgba[:, head, 0], x / 2.5)
    elif variation == "pos":
        x = st.var.geom_pos[:, head, 0]
        assert bool(((x >= -0.24) & (x <= -0.10)).all())
        torch.testing.assert_close(st.var.geom_pos[:, neck, 0],
                                   -0.14 - (-0.24 - x))
    else:
        r, h = st.var.geom_size[:, head, 0], st.var.geom_size[:, head, 1]
        assert bool(((r >= 0.01) & (r <= 0.04)).all())
        assert bool(((h >= 0.02) & (h <= 0.08)).all())
    a = torch.as_tensor(np.random.default_rng(4).uniform(
        -1.0, 1.0, (8, env.nu)).astype(np.float32))
    st = venv.step(st, a)
    assert bool(torch.isfinite(st.data.qpos).all())
    assert int(st.nan_resets.sum()) == 0


def test_step_no_reset_chunks_change_only_the_schedule(envs_pair):
    """`step_no_reset` in chunks of 4 equals one unchunked `step`, and
    never resets (step_count runs past the cap)."""
    p = envs_pair
    st = to_port(p["jst0"])
    st = st.replace(step_count=torch.full_like(st.step_count, 199))
    a = torch.as_tensor(np.random.default_rng(2).uniform(
        -1.0, 1.0, (N, p["tenv"].nu)).astype(np.float32))
    chunked = p["tv"].step_no_reset(st, a)
    whole = p["tenv"].step(st, a)
    for f in ("qpos", "qvel"):
        torch.testing.assert_close(getattr(chunked.data, f),
                                   getattr(whole.data, f), **TOL)
    torch.testing.assert_close(chunked.obs, whole.obs, **TOL)
    assert bool((chunked.step_count == 200).all())
    assert not chunked.done.any() and not chunked.truncated.any()


def test_evaluate_success_matches_jax(envs_pair):
    """% of paths with more than 25 successful steps, as the JAX env."""
    paths = np.random.default_rng(3).uniform(size=(16, 60)) > 0.5
    got = envs_pair["tenv"].evaluate_success(paths)
    assert got == envs_pair["jenv"].evaluate_success(paths)
    assert 0.0 < got < 100.0
