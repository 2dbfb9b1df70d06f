"""Top-level training entry point of the PyTorch port
(`mj_envs_tpu/run.py`, the `ppo` branch):

    python -m mj_envs_torch.run configs/hammer_ppo.json ppo

Trains on the card named by the config's `device_type` ("cuda" unless
the config says "cpu").  The other policy types of the JAX package
(dapg, npg, sac, planet) exit with a message naming the slice of the
port that brings them.

MJE_DEBUG_NANS=1 turns on `torch.autograd.set_detect_anomaly` (a
backward op that produces NaN raises with the forward op's traceback)
and makes a rollout step raise FloatingPointError on a non-finite env
state, which the quarantine would otherwise restart silently
(`envs/base.py` `step_auto_reset`).
"""
from __future__ import annotations

import os
import sys
import time

LATER = {
    "dapg": "the DAPG policies come with the NPG/DAPG learners",
    "default": "the DAPG policies come with the NPG/DAPG learners",
    "npg": "the NPG/DAPG learners",
    "sac": "the SAC learner and its replay buffer",
    "planet": "PlaNet comes with the renderer and the pixel envs",
}


def main(argv):
    import torch

    import mj_envs_torch  # noqa: F401  (float32 matmul settings)
    from mj_envs_torch import envs
    from mj_envs_torch.utils.config import PPOConfig, load_config

    config_path = argv[1] if len(argv) > 1 else None
    policy_type = argv[2] if len(argv) > 2 else "ppo"
    if policy_type in LATER:
        sys.exit(f"policy type {policy_type!r} is not in the PyTorch port "
                 f"yet: {LATER[policy_type]}, a later slice of the port")
    if policy_type != "ppo":
        raise ValueError(f"unknown policy type {policy_type}")

    debug_nans = os.environ.get("MJE_DEBUG_NANS", "") not in ("", "0")
    if debug_nans:
        torch.autograd.set_detect_anomaly(True)

    if config_path:
        config = load_config(config_path, policy_type)
    else:
        config = PPOConfig()
        config.env_name = "hammer-v0"
        config.max_episodes = 50
        config.test_interval = 25
        config.checkpoint_interval = 50
        config.num_envs = 256

    if not config.env_name:
        raise ValueError("config.env_name required")
    env = envs.make(config.env_name,
                    variation_type=config.variation_type or None,
                    device=config.device_type)

    out_dir = config.log_path or f"results/{config.run_id}_{policy_type}"
    os.makedirs(out_dir, exist_ok=True)
    config.save(os.path.join(out_dir, "config.json"))

    t0 = time.time()
    from mj_envs_torch.utils.train import train_ppo_policy
    train_ppo_policy(config, env, out_dir, device=config.device_type,
                     debug_nans=debug_nans)
    print(f"done in {time.time() - t0:.0f}s -> {out_dir}")


if __name__ == "__main__":
    main(sys.argv)
