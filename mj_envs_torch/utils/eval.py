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

`run_eval` is the reference's evaluation protocol, and `main` its CLI:

    python -m mj_envs_torch.utils.eval --config_path cfg.json \
        [--policy_type dapg] [--episodes 5] [--variation_type pos]

on the card named by the config's `device_type` ("cuda" unless the
config says "cpu").
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


def run_eval(config_path, policy_type="default", variation_type=None,
             episodes=5, out=None, episode_length=None, dapg_root=None):
    """The evaluation protocol (reference `mj_envs_vision/utils/
    eval.py:29-66`): episode `ep` evaluates 10 fresh envs with seed
    `config.seed + ep`, the worst trajectory of each episode (the lowest
    total reward, which the reference's "select worst" comment at
    `eval.py:60` intends) is rendered to a gif, and the reward and
    success plots are written at the end.  Runs on the config's
    `device_type`.

    policy_type: default / dapg (the pretrained DAPG policy of the task,
    from `dapg_root`, `algos/dapg.DEFAULT_ROOT` unless given), ppo (a
    checkpoint of the port at `config.models_path`, the CNN policy on
    pixels when the config's `model_type` is "cnn"), planet.
    `episode_length` cuts the episodes (default: the task's length,
    PlaNet's max_episode_length // action_repeat).  -> (out_path,
    model_name)."""
    import os

    from .. import envs
    from .. import visualize as V
    from . import helpers as H
    from .config import load_config

    config = load_config(config_path, policy_type)
    config.max_episodes = episodes
    config.variation_type = variation_type
    env = envs.make(config.env_name, variation_type=variation_type,
                    device=config.device_type)
    out_path = out or os.path.dirname(config.models_path) or "results"
    os.makedirs(out_path, exist_ok=True)
    model_name = (os.path.basename(config.models_path or "golden")
                  .replace(".", "_") + "_var-"
                  + (variation_type or "fixed"))
    print(f"saving results to {out_path}")

    length = episode_length or env.MAX_EPISODE_STEPS
    task = config.env_name.replace("-v0", "")
    model_type = getattr(config, "model_type", "mlp") or "mlp"
    if policy_type in ("default", "dapg"):
        from ..algos import dapg
        act_fn, _ = dapg.load_policy(task, env.device, env.dtype,
                                     root=dapg_root or dapg.DEFAULT_ROOT)
        params = None
        evaluate = make_evaluate(env, dapg_policy_apply(act_fn), length)
    elif policy_type == "ppo":
        # The state MLP (64, 64), or the reference's ActorCriticCnnPolicy
        # on pixels (baselines.py:120-134).
        from ..algos import networks as N
        from . import checkpoint as CKPT
        if model_type == "cnn":
            module = N.CnnActorCritic(env.nu, device=env.device,
                                      dtype=env.dtype)
        else:
            module = N.ActorCritic(env.OBS_DIM, env.nu, (64, 64),
                                   device=env.device, dtype=env.dtype)
        params = CKPT.restore_module(config.models_path, module)

        def apply(module, obs, generator):
            return torch.clamp(module(obs)[0], -1.0, 1.0)

        if model_type == "cnn":
            from ..envs.pixels import PixelObservationEnv
            evaluate = make_pixel_evaluate(PixelObservationEnv(env), apply,
                                           length)
        else:
            evaluate = make_evaluate(env, apply, length)
    elif policy_type == "planet":
        # The belief-filtered act path (reference eval.py:36-44).
        params = load_planet_params(config, env)
        evaluate = make_planet_evaluate(
            env, config, episode_length
            or config.max_episode_length // config.action_repeat)
    else:
        raise SystemExit(f"unsupported policy_type {policy_type}")
    total_rewards, successes = [], []
    for ep in range(episodes):
        res = evaluate(params, config.seed + ep, count=10)  # reseed seed+ep
        total_rewards.append((ep, res.total_rewards))
        successes.append((ep, res.success_any.astype(int)))
        worst = int(np.argmin(res.total_rewards))
        frames = V.render_state_trajectory(env, res.qpos[worst])
        H.visualise_trajectory(ep, frames, out_path, prefix=model_name)
        print(f"ep {ep}: reward {res.total_rewards.mean():.1f} "
              f"success {res.success_rate:.0f}% "
              f"(worst traj #{worst}: {res.total_rewards[worst]:.1f})")

    H.save_rewards_plot(
        total_rewards,
        os.path.join(out_path, f"{model_name}_eval_rewards.png"),
        "total rewards")
    H.save_rewards_plot(
        successes,
        os.path.join(out_path, f"{model_name}_eval_success.png"),
        "success rate")
    return out_path, model_name


def main(argv=None):
    """The CLI over `run_eval` (the JAX package's options)."""
    import argparse
    ap = argparse.ArgumentParser(description="evaluate a policy "
                                 "(mj_envs_torch.utils.eval.run_eval)")
    ap.add_argument("--config_path", type=str, required=True)
    ap.add_argument("--policy_type", type=str, default="default",
                    help="{default, dapg, ppo, planet}")
    ap.add_argument("--variation_type", type=str, default=None)
    ap.add_argument("--episodes", type=int, default=5)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    run_eval(args.config_path, args.policy_type, args.variation_type,
             args.episodes, args.out)


if __name__ == "__main__":
    main()
