"""Evaluation of the PyTorch port (`mj_envs_tpu/utils/eval.py:1-84`).

The reference protocol: fresh episodes of a fixed length, total reward
and `success |= goal_achieved` per episode, trajectories returned.  Here
`count` envs run as one batch on the env's device, reset together and
stepped with the plain `env.step` (no auto-reset: the episode has a
fixed length).  The env-level success metric (% of paths with more than
SUCCESS_STEPS goal-achieved steps) comes from the same rollout.  The
DAPG policy goes through `dapg_policy_apply`; the pixel and PlaNet
evaluators and the `run_eval` CLI come in later slices of the port.
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

    def evaluate(params, seed: int = 0, count: int = 10) -> EvalResult:
        gen = env.generator(seed)
        outs = []
        with torch.no_grad():
            st = env.reset(count, gen)
            for _ in range(episode_length):
                st = env.step(st, policy_apply(params, st.obs, gen))
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
