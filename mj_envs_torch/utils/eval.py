"""Evaluation of the PyTorch port (`mj_envs_tpu/utils/eval.py:1-84`).

The reference protocol: fresh episodes of a fixed length, total reward
and `success |= goal_achieved` per episode, trajectories returned.  Here
`count` envs run as one batch on the env's device, reset together and
stepped with the plain `env.step` (no auto-reset: the episode has a
fixed length).  The env-level success metric (% of paths with more than
SUCCESS_STEPS goal-achieved steps) comes from the same rollout.  The
DAPG policy goes through `dapg_policy_apply`; `make_pixel_evaluate`
feeds a pixel policy the rendered frames, and `make_planet_evaluate`
acts through PlaNet's belief filter and planner.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..envs.base import AdroitEnv


class EvalResult(NamedTuple):
    total_rewards: np.ndarray     # (count,)
    success_any: np.ndarray       # (count,) bool — reference `success`
    success_rate: float           # evaluate_success percentage
    goal_achieved: np.ndarray     # (count, T) bool
    obs: np.ndarray               # (count, T, obs_dim) — trajectories
    qpos: np.ndarray              # (count, T, nq)
    reward: np.ndarray            # (count, T) per-step rewards


def make_evaluate(env: AdroitEnv, policy_apply: Callable,
                  episode_length: int):
    """Returns `evaluate(params, seed, count=10) -> EvalResult`.

    policy_apply(params, obs, generator) -> action in [-1, 1]; the
    generator (on the env's device, seeded by `seed`) also draws the
    resets."""

    return _make_evaluate(env, policy_apply, episode_length,
                          lambda st: st.obs)


def _make_evaluate(env: AdroitEnv, policy_apply: Callable,
                   episode_length: int, observe: Callable):
    """`make_evaluate` with the policy fed observe(state)."""

    def evaluate(params, seed: int = 0, count: int = 10) -> EvalResult:
        gen = env.generator(seed)
        outs = []
        with torch.no_grad():
            st = env.reset(count, gen)
            for _ in range(episode_length):
                st = env.step(st, policy_apply(params, observe(st), gen))
                outs.append((st.obs, st.reward, st.goal_achieved, st.done,
                             st.data.qpos))
        return _finish_eval(env, *(torch.stack(xs) for xs in zip(*outs)))

    return evaluate


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _finish_eval(env, obs, rew, goal, done, qpos) -> EvalResult:
    """An EvalResult from time-first (T, count, ...) outputs, tensors or
    arrays."""
    rew = _host(rew).T
    goal = _host(goal).T
    obs = _host(obs).transpose(1, 0, 2)
    qpos = _host(qpos).transpose(1, 0, 2)
    # The reference keeps stepping after a termination (fixed length):
    # full sums.
    total = rew.sum(axis=1)
    success_any = goal.any(axis=1)
    success_rate = env.evaluate_success(goal)
    return EvalResult(total_rewards=total, success_any=success_any,
                      success_rate=success_rate, goal_achieved=goal,
                      obs=obs, qpos=qpos, reward=rew)


def dapg_policy_apply(act_fn: Callable):
    """Wrap a DAPG deterministic policy (`algos.dapg.make_policy`) into
    the evaluate() signature, its action clipped to [-1, 1]."""
    def apply(params, obs, generator):
        del params, generator
        return torch.clamp(act_fn(obs), -1.0, 1.0)
    return apply


def make_pixel_evaluate(penv, policy_apply: Callable, episode_length: int):
    """`make_evaluate` for a stateless pixel policy (the CNN-PPO family,
    `eval.py:88-121`): policy_apply(params, pixels, generator) -> action
    in [-1, 1], fed the frames `penv` renders after each step."""
    return _make_evaluate(penv.env, policy_apply, episode_length,
                          penv._render)


def make_planet_evaluate(env: AdroitEnv, config, episode_length: int):
    """Evaluate a PlaNet policy through its act path (`eval.py:124-171`;
    the reference's `Planet.act`, `baselines.py:311-320`): each step the
    frame is preprocessed to `config.bit_depth` bits with dequantization
    noise, the belief filtered with the last action, and the action
    planned by CEM.  The `count` envs filter and plan as one batch.
    `evaluate(module, seed, count)`; the generator seeded by `seed`
    draws the resets and every noise."""
    from ..algos import planet as PL
    from ..envs.pixels import PixelObservationEnv
    from ..render.raster import images_to_observation

    penv = PixelObservationEnv(env)
    cfg = PL.cfg_from_config(config, env.nu)
    _, _, infer_step, plan = PL.make_planet(cfg, device=env.device,
                                            dtype=env.dtype)

    def evaluate(module, seed: int = 0, count: int = 10) -> EvalResult:
        gen = env.generator(seed)
        outs = []
        with torch.no_grad():
            st = env.reset(count, gen)
            pix = penv._render(st)
            h = torch.zeros((count, cfg.belief_size), dtype=env.dtype,
                            device=env.device)
            s = torch.zeros((count, cfg.state_size), dtype=env.dtype,
                            device=env.device)
            a = torch.zeros((count, env.nu), dtype=env.dtype,
                            device=env.device)
            for _ in range(episode_length):
                obs = images_to_observation(pix, config.bit_depth, gen)
                h, s = infer_step(module, h, s, a, obs, gen)
                a = plan(module, h, s, gen)
                st = env.step(st, a)
                pix = penv._render(st)
                outs.append((st.obs, st.reward, st.goal_achieved, st.done,
                             st.data.qpos))
        return _finish_eval(env, *(torch.stack(xs) for xs in zip(*outs)))

    return evaluate


def load_planet_params(config, env: AdroitEnv):
    """The PlaNet module of the checkpoint at `config.models_path` (as
    `train_planet_policy` saves it, {"params", "opt_state"}), with the
    shapes `config` implies, on the env's device."""
    from ..algos import planet as PL
    from . import checkpoint as CKPT
    cfg = PL.cfg_from_config(config, env.nu)
    init_fn = PL.make_planet(cfg, device=env.device, dtype=env.dtype)[0]
    return CKPT.restore(config.models_path, init_fn(0)).params
