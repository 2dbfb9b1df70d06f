"""Checkpoint / resume of the PyTorch port (`mj_envs_tpu/utils/
checkpoint.py`): the same `ckpt_{step:08d}` naming and latest-by-step
rule.

A checkpoint is one `torch.save` file of the train state: the module's
and optimizer's `state_dict`s and the states of the train state's
generators.  The JAX package's flax msgpack checkpoints are not read
(flax and msgpack are not on the card's machine); weights cross from the
JAX package through `algos.networks.actor_critic_from_numpy`.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, Optional

import torch


def _state_dict(state) -> Dict[str, Any]:
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Generator):
            out[f.name] = v.get_state()
        elif hasattr(v, "state_dict"):
            out[f.name] = v.state_dict()
        else:
            raise TypeError(f"cannot checkpoint field {f.name!r} "
                            f"({type(v).__name__})")
    return out


def save(path: str, state) -> str:
    """Write `state` (a dataclass of modules, optimizers and generators,
    such as `algos.ppo.TrainState`) to `path`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(_state_dict(state), path)
    return path


def restore(path: str, target):
    """Load `path` into `target` (same fields; it supplies the modules,
    their devices and dtypes, as the JAX package's target pytree does)
    and return it."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    for f in dataclasses.fields(target):
        v = getattr(target, f.name)
        if isinstance(v, torch.Generator):
            v.set_state(saved[f.name])
        else:
            v.load_state_dict(saved[f.name])
    return target


_CKPT_RE = re.compile(r"ckpt_(\d+)\.pt$")


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.pt")


def latest(directory: str) -> Optional[str]:
    """Latest checkpoint by step (the reference resumes 'latest by
    sorted filename')."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        mt = _CKPT_RE.search(name)
        if mt and int(mt.group(1)) > best_step:
            best_step = int(mt.group(1))
            best = os.path.join(directory, name)
    return best
