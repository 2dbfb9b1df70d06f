"""Task-environment registry of the PyTorch port (hammer-v0 in this
slice of the port; door/pen/relocate follow)."""
from __future__ import annotations

from typing import Optional

from .base import AdroitEnv, EnvState, ModelVar
from .hammer import HammerEnv

_REGISTRY = {
    "hammer-v0": HammerEnv,
    "hammer": HammerEnv,
}


def make(env_id: str, variation_type: Optional[str] = None,
         device="cuda", **kwargs) -> AdroitEnv:
    """Build a task env on `device` (the card by default; raises without
    one unless device='cpu' is passed)."""
    if env_id not in _REGISTRY:
        raise ValueError(
            f"Unknown env '{env_id}'; available: "
            f"{sorted(k for k in _REGISTRY if k.endswith('-v0'))}")
    return _REGISTRY[env_id](variation_type=variation_type, device=device,
                             **kwargs)


__all__ = ["make", "AdroitEnv", "EnvState", "ModelVar", "HammerEnv"]
