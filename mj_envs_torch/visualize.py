"""Policy visualization CLI of the PyTorch port (`mj_envs_tpu/
visualize.py`; the reference's `mj_envs_vision/utils/visualize_env.py`).

    python -m mj_envs_torch.visualize --env_name hammer-v0 \\
        [--policy ckpt-or-pickle] [--episodes 2] [--seed 123] \\
        [--variation_type mass] [--out results/vis] [--device cuda]

The reference's behaviours, as the JAX package keeps them:
* the policy type is sniffed from the policy's file name: "planet" -> a
  PlaNet checkpoint, none, "dapg" or a `.pickle` -> a DAPG policy (none
  or "dapg" the pretrained one), anything else a PPO checkpoint
  (`visualize_env.py:37-47`);
* per episode a rollout of the policy, saved as
  `visualise_<env>_<policy>_<k>.gif`, and a reward plot at the end
  (`visualize_env.py:109-140`).

Frames come from the port's ray-caster at 128x128 (the reference's crop
size), on the card unless `--device cpu`.  The port's checkpoints are
`torch.save` files (`utils/checkpoint.py`), not the JAX package's
msgpack.  `--max_steps` caps an episode (default: the task's length).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def _frame(pixels: torch.Tensor) -> np.ndarray:
    return pixels[0].cpu().numpy()


@torch.no_grad()
def _rollout_frames(env, act_fn, seed: int, max_steps: int):
    """Single-env rollout with a 128x128 frame per step: act_fn(obs
    (1, obs_dim)) -> (1, nu), clipped to [-1, 1]; the env's generator
    seeded by `seed`; stops at `done`.  -> (frames, rewards)."""
    from .envs.pixels import PixelObservationEnv

    penv = PixelObservationEnv(env, height=128, width=128)
    gen = env.generator(seed)
    ps = penv.reset(1, gen)
    frames, rewards = [_frame(ps.pixels)], []
    for _ in range(max_steps):
        a = act_fn(ps.state.obs)
        ps = penv.step(ps, torch.clamp(a, -1.0, 1.0), gen)
        frames.append(_frame(ps.pixels))
        rewards.append(float(ps.state.reward[0]))
        if bool(ps.state.done[0]):
            break
    return frames, rewards


@torch.no_grad()
def _rollout_frames_planet(env, config, module, seed: int, max_steps: int):
    """Single-env PlaNet rollout with 128x128 frames: the planner sees
    the 64x64 preprocessed observation (resize and `config.bit_depth`
    bits with dequantization noise) while the gif gets the full crop
    (the reference's planet path, `visualize_env.py:37-47`: preprocess
    -> encoder -> RSSM filter -> CEM plan, `baselines.py:311-320`).  All
    noise is drawn from the env's generator seeded by `seed`."""
    from .algos import planet as PL
    from .envs.pixels import PixelObservationEnv
    from .render.raster import images_to_observation, resize_half

    penv = PixelObservationEnv(env, height=128, width=128)
    cfg = PL.cfg_from_config(config, env.nu)
    _, _, infer_step, plan = PL.make_planet(cfg, device=env.device,
                                            dtype=env.dtype)
    gen = env.generator(seed)
    ps = penv.reset(1, gen)
    zeros = lambda n: torch.zeros((1, n), dtype=env.dtype, device=env.device)
    h, s, a = zeros(cfg.belief_size), zeros(cfg.state_size), zeros(env.nu)
    frames, rewards = [_frame(ps.pixels)], []
    for _ in range(max_steps):
        obs = images_to_observation(resize_half(ps.pixels),
                                    config.bit_depth, gen)
        h, s = infer_step(module, h, s, a, obs, gen)
        a = plan(module, h, s, gen)
        ps = penv.step(ps, a, gen)
        frames.append(_frame(ps.pixels))
        rewards.append(float(ps.state.reward[0]))
        if bool(ps.state.done[0]):
            break
    return frames, rewards


@torch.no_grad()
def render_state_trajectory(env, qpos_traj, height: int = 128,
                            width: int = 128):
    """Re-render a recorded qpos trajectory (T, nq), array or tensor ->
    a list of (H, W, 3) float32 frames in [0, 255].  FK on the env's
    device (the FK kernel on the card), the pixel env's camera, and
    `env.model` with no variation applied, as the JAX function renders.
    The frames are rendered as a batch, RENDER_CHUNK at a time (the JAX
    function maps one frame at a time to bound its memory)."""
    from .envs.pixels import RENDER_CHUNK, PixelObservationEnv
    from .physics.kinematics import kinematics
    from .render import raster

    penv = PixelObservationEnv(env, height=height, width=width)
    dirs = raster.camera_rays(penv.camera, height, width, env.device)
    q = torch.as_tensor(qpos_traj).to(env.device, env.dtype)
    frames = []
    for i in range(0, q.shape[0], RENDER_CHUNK):
        kin = kinematics(env.model, q[i:i + RENDER_CHUNK])
        img = raster.render(env.model, kin.geom_xpos, kin.geom_xmat,
                            penv.camera, height, width, dirs=dirs)
        frames += list(img.cpu().numpy())
    return frames


def _load_policy(policy_path, env, task):
    """-> (act_fn, name): the reference's policy-type sniffing
    (`visualize_env.py:37-47`).  act_fn(obs (B, obs_dim)) -> (B, nu) on
    the env's device."""
    from .algos import dapg

    if policy_path is None or "dapg" in str(policy_path) \
            or str(policy_path).endswith(".pickle"):
        if policy_path and str(policy_path).endswith(".pickle"):
            params = dapg.load_dapg_params(policy_path)
            return dapg.make_policy(params, env.device, env.dtype), "dapg"
        act, _ = dapg.load_policy(task, env.device, env.dtype)
        return act, "dapg-golden"
    # (PlaNet checkpoints go to _rollout_frames_planet in main: its act
    # path carries a belief.)  A PPO checkpoint of the port.
    from .algos import networks as N
    from .utils import checkpoint as CKPT
    module = CKPT.restore_module(policy_path, N.ActorCritic(
        env.OBS_DIM, env.nu, (64, 64), device=env.device, dtype=env.dtype))
    return (lambda obs: module(obs)[0]), "ppo"


def main(argv=None):
    from . import envs
    from .utils import helpers as H

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--env_name", type=str, required=True)
    ap.add_argument("--policy", type=str, default=None,
                    help="path to a policy checkpoint/pickle (default: "
                         "pretrained DAPG golden policy)")
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--episodes", type=int, default=1)
    ap.add_argument("--variation_type", type=str, default=None)
    ap.add_argument("--out", type=str, default="results/vis")
    ap.add_argument("--config_path", type=str, default=None,
                    help="run config JSON (required for planet checkpoints "
                         "with non-default model sizes)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--max_steps", type=int, default=None,
                    help="cap each episode (default: the task's length)")
    args = ap.parse_args(argv)

    env = envs.make(args.env_name, variation_type=args.variation_type,
                    device=args.device)
    task = args.env_name.replace("-v0", "")
    policy = args.policy

    planet_cfg = None
    if policy and "planet" in str(policy):
        from .utils.config import PlanetConfig, load_config
        from .utils.eval import load_planet_params
        planet_cfg = (load_config(args.config_path, "planet")
                      if args.config_path else PlanetConfig())
        planet_cfg.models_path = policy
        planet_module = load_planet_params(planet_cfg, env)
        policy_name = "planet"
        length = planet_cfg.max_episode_length // planet_cfg.action_repeat
    else:
        act_fn, policy_name = _load_policy(policy, env, task)
        length = env.MAX_EPISODE_STEPS
    if args.max_steps is not None:
        length = args.max_steps
    os.makedirs(args.out, exist_ok=True)
    print(f"saving renderings to {args.out}")

    all_rewards = []
    for k in range(args.episodes):
        if planet_cfg is not None:
            frames, rewards = _rollout_frames_planet(
                env, planet_cfg, planet_module, args.seed + k, length)
        else:
            frames, rewards = _rollout_frames(env, act_fn, args.seed + k,
                                              length)
        gif = os.path.join(
            args.out, f"visualise_{args.env_name}_{policy_name}_{k}.gif")
        H.save_as_gif(frames, gif)
        all_rewards.append((k, float(np.sum(rewards))))
        print(f"episode {k}: total reward {np.sum(rewards):.1f} "
              f"({len(frames)} frames) -> {gif}")

    H.save_rewards_plot(all_rewards,
                        os.path.join(args.out, f"rewards_{args.env_name}.png"))
    print("done")


if __name__ == "__main__":
    main()
