"""Top-level training entry point of the PyTorch port
(`mj_envs_tpu/run.py`):

    python -m mj_envs_torch.run configs/hammer_ppo.json ppo
    python -m mj_envs_torch.run configs/door_npg.json npg
    python -m mj_envs_torch.run configs/relocate_sac.json sac
    python -m mj_envs_torch.run configs/door_npg.json dapg
    python -m mj_envs_torch.run configs/hammer_planet.json planet

PPO on state observations trains over the cards of one node under
torchrun, data-parallel: each process joins the group, steps
`num_envs` envs on its card (the global batch is num_envs x the
processes), and every process runs the update on the gathered batch
(`utils/train.train_ppo_policy(mesh=...)`); rank 0 alone logs the
global env-steps, evaluates and writes the results.  Without torchrun
the run is one process on one card.

    torchrun --standalone --nproc_per_node=4 -m mj_envs_torch.run \
        configs/hammer_ppo.json ppo

Policy types: ppo (on pixels when the config's `model_type` is "cnn"),
npg (natural policy gradient), sac (soft actor-critic), dapg or default
(evaluate the pretrained DAPG policy of the config's task, from the
reference checkout's pickles), planet (RSSM and CEM on pixel
observations).  Runs on the card named by the config's `device_type`
("cuda" unless the config says "cpu").

MJE_DEBUG_NANS=1 turns on `torch.autograd.set_detect_anomaly` (a
backward op that produces NaN raises with the forward op's traceback)
and makes a PPO rollout step raise FloatingPointError on a non-finite env
state, which the quarantine would otherwise restart silently
(`envs/base.py` `step_auto_reset`).
"""
from __future__ import annotations

import os
import sys
import time

POLICY_TYPES = ("ppo", "npg", "sac", "dapg", "default", "planet")


def main(argv):
    import torch
    import torch.distributed as dist

    import mj_envs_torch  # noqa: F401  (float32 matmul settings)
    from mj_envs_torch.parallel import distributed as D
    from mj_envs_torch.utils.config import PPOConfig, load_config

    config_path = argv[1] if len(argv) > 1 else None
    policy_type = argv[2] if len(argv) > 2 else "ppo"
    if policy_type not in POLICY_TYPES:
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

    joined = not dist.is_initialized()
    D.initialize(device=config.device_type)      # torchrun's group, if any
    try:
        _run(config, policy_type, debug_nans)
    finally:
        if joined and dist.is_initialized():
            dist.destroy_process_group()


def _run(config, policy_type: str, debug_nans: bool):
    import torch.distributed as dist

    from mj_envs_torch import envs
    from mj_envs_torch.parallel import distributed as D

    mesh = None
    if dist.is_initialized():
        if policy_type != "ppo":
            raise ValueError(f"{policy_type} runs on one card: only ppo "
                             f"trains over the cards of a torchrun group")
        mesh = D.make_mesh(device=config.device_type)
    lead = mesh is None or dist.get_rank() == 0
    env = envs.make(config.env_name,
                    variation_type=config.variation_type or None,
                    device=config.device_type)

    out_dir = config.log_path or f"results/{config.run_id}_{policy_type}"
    if lead:
        os.makedirs(out_dir, exist_ok=True)
        config.save(os.path.join(out_dir, "config.json"))

    t0 = time.time()
    if policy_type == "ppo":
        from mj_envs_torch.utils.train import train_ppo_policy
        train_ppo_policy(config, env, out_dir, debug_nans=debug_nans,
                         mesh=mesh)
    elif policy_type in ("dapg", "default"):
        from mj_envs_torch.algos import dapg
        from mj_envs_torch.utils.eval import dapg_policy_apply, make_evaluate
        task = config.env_name.replace("-v0", "")
        act_fn, _ = dapg.load_policy(task, device=config.device_type,
                                     dtype=env.dtype)
        evaluate = make_evaluate(env, dapg_policy_apply(act_fn),
                                 env.MAX_EPISODE_STEPS)
        res = evaluate(None, config.seed, count=10)
        print(f"dapg eval: reward {res.total_rewards.mean():.1f} "
              f"success {res.success_rate:.1f}%")
    elif policy_type == "npg":
        from mj_envs_torch.utils.train import train_npg_policy
        train_npg_policy(config, env, out_dir)
    elif policy_type == "sac":
        from mj_envs_torch.utils.train import train_sac_policy
        train_sac_policy(config, env, out_dir)
    else:
        from mj_envs_torch.utils.train import train_planet_policy
        train_planet_policy(config, env, out_dir)
    if lead:
        print(f"done in {time.time() - t0:.0f}s -> {out_dir}")


if __name__ == "__main__":
    main(sys.argv)
