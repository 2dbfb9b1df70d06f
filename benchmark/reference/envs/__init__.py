"""Task envs of the reference, by the port's names: `<task>-v0` is the
`AdroitEnv` subclass in `envs/<task>.py` whose TASK is `<task>`."""
from __future__ import annotations

import importlib

from .base import AdroitEnv, EnvState, ModelVar


def make(env_id: str, device="cpu", dtype=None) -> AdroitEnv:
    """The reference's task env `env_id` on `device` in `dtype`
    (float64 unless given)."""
    import torch
    task = env_id.split("-")[0]
    mod = importlib.import_module(f".{task}", __name__)
    cls = next(c for c in vars(mod).values() if isinstance(c, type)
               and issubclass(c, AdroitEnv) and c.TASK == task)
    return cls(device=device, dtype=dtype or torch.float64)


__all__ = ["make", "AdroitEnv", "EnvState", "ModelVar"]
