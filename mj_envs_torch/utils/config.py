"""JSON-compatible config system of the PyTorch port, a copy of
`mj_envs_tpu/utils/config.py` with the same keys, defaults and JSON
behaviour, so the committed `configs/*.json` drop in unchanged.  The one
difference: `device_type` defaults to "cuda" (the JAX package's "tpu").

Mirrors the reference's attribute-bag `Config` (`mj_envs_vision/utils/
config.py:7-116`): JSON load with unknown-key warnings, subclass-per-
algorithm (`PlanetConfig`, `PPOConfig`) and `load_config` dispatch.  The
JAX package's additions live under explicit keys (num_envs, mesh_shape,
dtype) with safe defaults.  The reference's `Config.save` bug (dumping a
fresh default instead of `self`) is fixed, not replicated.
"""
from __future__ import annotations

import json
from typing import Optional


class Config:
    def __init__(self):
        # General parameters (reference defaults, config.py:12-43).
        self.run_id = 0
        self.seed = 0
        self.device_type = "cuda"
        self.disable_cuda = False
        self.models_path = ""
        self.log_path: Optional[str] = None
        self.nogui = True
        # Algorithm parameters.
        self.seed_episodes = 2
        self.max_episodes = 1000
        self.max_episode_length = 500
        self.experience_size = 1000000
        self.sample_iters = 1000
        self.test_interval = 100
        self.activation_fn = "relu"
        self.action_noise = 0.3
        self.learning_rate = 1e-3
        self.learning_rate_factor = 0
        self.adam_epsilon = 1e-4
        self.grad_clip_norm = 1000
        self.candidates = 1000
        self.top_candidates = 100
        self.checkpoint_interval = 100
        # Environment parameters.
        self.env_name: Optional[str] = None
        self.action_repeat = 2
        self.state_type = "observation"
        self.variation_type: Optional[str] = None
        self.bit_depth = 5
        # Memory parameters.
        self.batch_size = 50
        self.chunk_size = 50
        # Additions of the JAX package.
        self.num_envs = 1024
        self.mesh_shape = None        # e.g. [8, 1] -> (env, model)
        self.dtype = "float32"

    def load(self, filepath: str):
        with open(filepath, "r") as fp:
            cfg = json.load(fp)
        if isinstance(cfg, str):
            cfg = json.loads(cfg)
        for att, v in cfg.items():
            if att in self.__dict__:
                self.__dict__[att] = v
            else:
                print(f"No such config field, '{att}'.")
        return self

    def save(self, filepath: str):
        with open(filepath, "w") as fp:
            json.dump(self.__dict__, fp, indent=2)

    def str(self):
        s = "Parameters:\n"
        for att, v in self.__dict__.items():
            s += f"\t\t{att:<25} = {v}\n"
        return s


class PlanetConfig(Config):
    def __init__(self):
        super().__init__()
        self.belief_size = 200
        self.state_size = 30
        self.embedding_size = 1024
        self.hidden_size = 200
        self.overshooting_distance = 50
        self.overshooting_kl_beta = 0
        self.overshooting_reward_scale = 0
        self.free_nats = 3
        self.planning_horizon = 12
        self.optimisation_iters = 10


class PPOConfig(Config):
    def __init__(self):
        super().__init__()
        self.model_type = "mlp"
        self.n_steps = 64
        self.n_minibatches = 8
        self.n_epochs = 4
        self.gamma = 0.99
        self.gae_lambda = 0.95
        self.clip_eps = 0.2


def load_config(config_path: str, policy_type: str) -> Config:
    if policy_type == "ppo":
        config: Config = PPOConfig()
    elif policy_type == "planet":
        config = PlanetConfig()
    else:
        config = Config()
    config.load(config_path)
    print(config.str())
    return config
