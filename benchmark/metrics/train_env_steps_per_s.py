"""train_env_steps_per_s: the env-steps of the window's whole PPO
iterations (rollout, GAE, update) over its time."""
from benchmark.lib.readers import rate as read  # noqa: F401
