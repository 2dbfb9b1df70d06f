"""env_steps_per_s: all env-steps of the rollout window over its time."""
from benchmark.lib.readers import rate as read  # noqa: F401
