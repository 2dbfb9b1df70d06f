"""Pixel PPO of the port (`algos/ppo.make_pixel_ppo`) against the JAX
package's (`mj_envs_tpu/algos/ppo.make_pixel_ppo`), CPU: 4 hammer-v0 envs
x 2 steps, 2 epochs x 2 minibatches.

* The rollout (float32): both sides start from the JAX reset states with
  the same CNN weights, and the port takes the JAX package's action
  normals.  The JAX side is `make_pixel_ppo`'s rollout written out with
  the JAX package's own pieces (its batched step pair, `_render`,
  `cnn_actor_critic_apply`), so that one hammer step compiles once.
  Each side renders its own frames: the stored uint8 frames may differ
  where a ray grazes an edge (at most 0.5 % of the values by more than
  1, `tests/test_torch_render.py`'s share), and the actions, values,
  rewards and states are held within their floors.
* The update (float64 and float32): the port's `_make_update` on the
  JAX trajectory itself (its uint8 frames, advantages, returns and
  permutations) against the JAX package's `_make_update`, so that the
  CNN's gradients on the stored frames are held at the arithmetic's
  floor, far below the update's own movement.

Every bound is 4x the worst over seeds 0-2 (`python
tests/measure_torch_learner_floors.py pixel_ppo`).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mj_envs_tpu import envs as jenvs
from mj_envs_tpu.algos import networks as JN
from mj_envs_tpu.algos import ppo as JP
from mj_envs_tpu.envs.pixels import PixelObservationEnv as JPixels
from mj_envs_tpu.render import raster as JR
from mj_envs_torch import envs as tenvs
from mj_envs_torch.algos import networks as TN
from mj_envs_torch.algos import ppo as TP
from mj_envs_torch.envs.pixels import PixelEnvState
from mj_envs_torch.envs.pixels import PixelObservationEnv as TPixels
from test_torch_ppo import jax_perms, jax_rollout_draws, jax_tx, to_port

N_ENVS = 4
ITER_CFG = dict(n_steps=2, n_minibatches=2, n_epochs=2)
PIXEL_SHARE = 0.005
FIELDS = ("action", "log_prob", "value", "reward", "trunc_boot")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)    # six xdist workers share the CPU
    yield
    torch.set_num_threads(n)


def _per_env(fn):
    """fn of one env, jitted once, over the leading (env) axis of its
    arguments, which are pytrees of arrays: -> its results stacked, as
    numpy.  Without `vmap` the JAX hammer step pair traces and compiles
    in about 70 % of the time, and XLA compiles it without its LLVM
    optimisation passes in about two thirds.  The operations are the
    same; only the fusion of multiply-adds may round otherwise, which the
    float32 floors below cover."""
    compiled = []

    def call(*args):
        args = jax.tree_util.tree_map(np.asarray, args)
        outs = []
        for i in range(len(jax.tree_util.tree_leaves(args)[0])):
            one = jax.tree_util.tree_map(lambda x: x[i], args)
            if not compiled:
                compiled.append(jax.jit(fn).lower(*one).compile(
                    compiler_options={"xla_backend_optimization_level": 0}))
            outs.append(compiled[0](*one))
        return jax.tree_util.tree_map(
            lambda *xs: np.stack([np.asarray(x) for x in xs]), *outs)

    return call


_WORLD = {}


def world():
    """The JAX and port hammer envs with their pixel envs and the JAX
    reset, batched step pair, render and CNN (built once)."""
    if not _WORLD:
        jenv = jenvs.make("hammer-v0")
        tpen = TPixels(tenvs.make("hammer-v0", device="cpu"))
        # The JAX pixel env without its constructor (whose jitted
        # kinematics costs ~10 s to compile): the camera from the JAX
        # package's `free_camera` at the port's lookat and elevation,
        # which `tests/test_torch_render.py` holds to the JAX package's.
        jpen = JPixels.__new__(JPixels)
        jpen.env, jpen.height, jpen.width = jenv, 64, 64
        jpen.camera = JR.free_camera(tpen.stat_center, tpen.azimuth,
                                     tpen.elevation, tpen.distance,
                                     fovy_deg=45.0, height_px=480)
        _WORLD.update(
            jenv=jenv, jpen=jpen, tpen=tpen,
            reset=_per_env(jenv.reset),
            pair=_per_env(jenv._step_auto_reset_pair),
            render=jax.jit(jax.vmap(jpen._render)),
            apply=jax.jit(JN.cnn_actor_critic_apply),
            init=jax.jit(JN.cnn_actor_critic_init, static_argnums=1))
    return _WORLD


def jax_pixel_rollout(w, params, st, pixels, noise, cfg):
    """`make_pixel_ppo`'s rollout (`ppo.py:243-266`) with the given
    normals: the JAX trajectory and the last (state, pixels)."""
    out = []
    for t in range(cfg.n_steps):
        mean, log_std, value = w["apply"](params, pixels)
        action = mean + jnp.exp(log_std) * noise[t]
        logp = JN.gaussian_log_prob(mean, log_std, action)
        merged, raw = w["pair"](st, jnp.clip(action, -1.0, 1.0))
        nxt = w["render"](merged)
        v_final = (w["apply"](params, w["render"](raw))[2]
                   if bool(jnp.any(merged.truncated))
                   else jnp.zeros_like(value))
        out.append(JP.Transition(
            obs=jnp.round(pixels).astype(jnp.uint8), action=action,
            log_prob=logp, value=value, reward=merged.reward,
            done=merged.done,
            trunc_boot=jnp.where(merged.truncated, v_final, 0.0)))
        st, pixels = merged, nxt
    return st, pixels, JP.Transition(*(jnp.stack(xs) for xs in zip(*out)))


_JAX_ITER = {}


def jax_iteration(seed):
    """One JAX pixel-PPO iteration's inputs and rollout from seed `seed`
    (made once per seed): the reset states and frames, the CNN weights,
    the action normals, the update's key and permutations, the
    trajectory, the last states and frames, and GAE's advantages and
    returns."""
    if seed not in _JAX_ITER:
        w = world()
        cfg = JP.PPOConfig(**ITER_CFG)
        st = w["reset"](jax.random.split(jax.random.PRNGKey(seed + 1),
                                         N_ENVS))
        pixels = w["render"](st)
        p = w["init"](jax.random.PRNGKey(seed), w["jenv"].nu)
        p["log_std"] = jnp.asarray(
            0.2 * np.random.default_rng(seed + 100)
            .standard_normal(w["jenv"].nu).astype(np.float32))
        noise, ukey = jax_rollout_draws(jax.random.PRNGKey(seed + 2),
                                        cfg.n_steps, N_ENVS, w["jenv"].nu,
                                        np.float32)
        st2, pixels2, traj = jax_pixel_rollout(w, p, st, pixels, noise, cfg)
        adv, ret = JP._gae(cfg, traj, w["apply"](p, pixels2)[2])
        _JAX_ITER[seed] = dict(
            st=st, p=p, noise=noise, ukey=ukey,
            perms=jax_perms(ukey, cfg.n_epochs, cfg.n_steps * N_ENVS),
            traj=traj, st2=st2, adv=adv, ret=ret)
    return _JAX_ITER[seed]


def max_err(t, j):
    t = t.detach().double().numpy() if isinstance(t, torch.Tensor) else t
    return float(np.abs(np.asarray(t, np.float64)
                        - np.asarray(j, np.float64)).max())


def pixel_iteration_errors(seed):
    """The port's rollout from the JAX iteration's states, weights and
    normals: {quantity: max abs error}, `obs` as the share of frame
    values more than 1 apart."""
    w, j = world(), jax_iteration(seed)
    cfg = TP.PPOConfig(**ITER_CFG)
    tpen = w["tpen"]
    mod = TN.cnn_actor_critic_from_numpy(j["p"], device="cpu")
    ts = TP.TrainState(mod, TP.make_optimizer(mod, cfg),
                       torch.Generator().manual_seed(0),
                       tpen.env.generator(0))
    st = to_port(j["st"], torch.float32)
    ps = PixelEnvState(state=st, pixels=tpen._render(st))
    ps2, traj_t = TP.make_pixel_rollout(tpen, cfg)(
        ts, ps, torch.as_tensor(j["noise"]))
    traj_j = j["traj"]
    assert traj_t.obs.dtype == torch.uint8
    assert torch.equal(traj_t.done, torch.as_tensor(np.array(traj_j.done)))
    frames = np.abs(traj_t.obs.numpy().astype(np.int32)
                    - np.asarray(traj_j.obs).astype(np.int32))
    e = {f: max_err(getattr(traj_t, f), getattr(traj_j, f)) for f in FIELDS}
    e["obs"] = float((frames > 1).mean())
    e["qpos"] = max_err(ps2.state.data.qpos, j["st2"].data.qpos)
    return e


def cnn_params_error(a, b):
    leaves = jax.tree_util.tree_leaves
    return max(max_err(x, y) for x, y in zip(leaves(a), leaves(b)))


def pixel_update_errors(seed, dtype):
    """`_make_update` of both packages on the JAX iteration's trajectory
    (uint8 frames, the float fields in `dtype`), advantages, returns and
    permutations, from the same weights in `dtype`: {"params": max abs
    error, "metrics": the largest metric's, "moved": how far the port's
    update moved its params, "moved_jax": the JAX package's}."""
    j = jax_iteration(seed)
    f = np.float64 if dtype == torch.float64 else np.float32
    cast = lambda x: x if x.dtype == jnp.uint8 else x.astype(f)  # noqa
    p = jax.tree_util.tree_map(lambda x: x.astype(f), j["p"])
    traj = JP.Transition(*(cast(x) for x in j["traj"]))
    adv, ret = j["adv"].astype(f), j["ret"].astype(f)
    cfg_j, cfg_t = JP.PPOConfig(**ITER_CFG), TP.PPOConfig(**ITER_CFG)
    tx = jax_tx(cfg_j)
    js, jm = jax.jit(JP._make_update(cfg_j, tx, JN.cnn_actor_critic_apply))(
        JP.TrainState(p, tx.init(p), j["ukey"]), traj, adv, ret)

    mod = TN.cnn_actor_critic_from_numpy(p, device="cpu", dtype=dtype)
    ts = TP.TrainState(mod, TP.make_optimizer(mod, cfg_t),
                       torch.Generator().manual_seed(0),
                       torch.Generator().manual_seed(1))
    tt = TP.Transition(*(torch.as_tensor(np.array(x)) for x in traj))
    tm = TP._make_update(cfg_t)(ts, tt, torch.as_tensor(np.array(adv)),
                                torch.as_tensor(np.array(ret)),
                                torch.as_tensor(j["perms"]))
    back = TN.cnn_actor_critic_to_numpy(mod)
    return dict(params=cnn_params_error(back, js.params),
                metrics=max(max_err(tm[k], jm[k]) for k in jm),
                moved=cnn_params_error(back, p),
                moved_jax=cnn_params_error(js.params, p))


# Rollout bounds (max abs), each 4x the worst over seeds 0-2: action
# 3.8e-5, log_prob 1.1e-5, value 1.5e-3, reward 1.4e-6, trunc_boot 0 (no
# episode ends in two steps), qpos 1.2e-6.  The frames each side renders
# differ in up to 5.1e-5 of their values (rays grazing an edge), which
# moves the CNN's outputs far more than the float32 sums do.
BOUNDS = dict(action=1.5e-4, log_prob=4.6e-5, value=6.0e-3, reward=5.7e-6,
              trunc_boot=0.0, qpos=4.6e-6)


def test_pixel_ppo_iteration_matches_jax():
    e = pixel_iteration_errors(0)
    assert e["obs"] <= PIXEL_SHARE, e
    over = {k: (e[k], b) for k, b in BOUNDS.items() if not e[k] <= b}
    assert not over, (over, e)


@pytest.mark.parametrize("dtype,bound", [
    (torch.float64, dict(params=7.0e-14, metrics=2.9e-14)),
    (torch.float32, dict(params=2.6e-5, metrics=1.5e-5))], ids=["f64", "f32"])
def test_pixel_update_matches_jax(dtype, bound):
    """Worst over seeds 0-2: float64 params 1.8e-14, metrics 7.1e-15;
    float32 params 6.4e-6 (Adam's near-sign steps of lr 3e-4 amplify a
    gradient's last bits), metrics 3.8e-6.  The update moves the params
    by 1.2e-3 (4 Adam steps of lr 3e-4): a wrong gradient or no update
    is off by about that much, the bounds are under 3 % of it."""
    e = pixel_update_errors(0, dtype)
    assert e["moved"] > 1e-3 and e["moved_jax"] > 1e-3, e
    assert bound["params"] < 0.03 * e["moved"], (bound, e)
    for k, b in bound.items():
        assert e[k] <= b, e
