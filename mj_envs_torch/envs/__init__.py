"""Task-environment registry of the PyTorch port (the JAX package's
names: hammer-v0 / door-v0 / pen-v0 / relocate-v0 with episode caps
200/200/100/200, and the bare task names)."""
from __future__ import annotations

from typing import Optional

from .. import trace
from .base import AdroitEnv, EnvState, ModelVar
from .door import DoorEnv
from .hammer import HammerEnv
from .pen import PenEnv
from .relocate import RelocateEnv

_REGISTRY = {
    "hammer-v0": HammerEnv,
    "door-v0": DoorEnv,
    "pen-v0": PenEnv,
    "relocate-v0": RelocateEnv,
    "hammer": HammerEnv,
    "door": DoorEnv,
    "pen": PenEnv,
    "relocate": RelocateEnv,
}


def make(env_id: str, variation_type: Optional[str] = None,
         device="cuda", **kwargs) -> AdroitEnv:
    """Build a task env on `device` (the card by default; raises without
    one unless device='cpu' is passed): the MJCF's parse, the model's
    build and its tensors on the device, the tracer's span
    `setup.model_build`."""
    if env_id not in _REGISTRY:
        raise ValueError(
            f"Unknown env '{env_id}'; available: "
            f"{sorted(k for k in _REGISTRY if k.endswith('-v0'))}")
    with trace.span("setup.model_build"):
        return _REGISTRY[env_id](variation_type=variation_type,
                                 device=device, **kwargs)


__all__ = ["make", "AdroitEnv", "EnvState", "ModelVar", "HammerEnv",
           "DoorEnv", "PenEnv", "RelocateEnv"]
