"""The benchmark's plain reference: what decides `correct`.

A frozen copy of the port's plain path, from the MJCF parse to obs,
reward and the auto-reset (`mjcf/`, `physics/`, `envs/`, `utils/`), with
every CUDA launch and every option read from the environment taken out,
and the plain PPO arithmetic (`policy.py`).  It imports nothing of the
port and nothing of JAX, rebuilds each model from its own copy of the
task's MJCF, and runs on any device in float64 (the reference) or
float32 (the lower-precision control).
"""
