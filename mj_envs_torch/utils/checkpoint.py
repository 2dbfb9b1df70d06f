"""Checkpoint / resume of the PyTorch port (`mj_envs_tpu/utils/
checkpoint.py`): the same `ckpt_{step:08d}` naming and latest-by-step
rule.

A checkpoint is one `torch.save` file of a train state, a dataclass
whose fields are modules and optimizers (their `state_dict`s),
generators (their states), tensors, Python ints, or dataclasses of those
(SAC's replay ring).  The JAX package's flax msgpack checkpoints are not
read (flax and msgpack are not on the card's machine); weights cross
from the JAX package through the `*_from_numpy` functions of
`algos/`.
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
        elif isinstance(v, torch.Tensor):
            out[f.name] = v.detach().cpu().clone()
        elif isinstance(v, int) and not isinstance(v, bool):
            out[f.name] = v
        elif dataclasses.is_dataclass(v):
            out[f.name] = _state_dict(v)
        elif hasattr(v, "state_dict"):
            out[f.name] = v.state_dict()
        else:
            raise TypeError(f"cannot checkpoint field {f.name!r} "
                            f"({type(v).__name__})")
    return out


def _restore(saved: Dict[str, Any], target):
    for f in dataclasses.fields(target):
        v, s = getattr(target, f.name), saved[f.name]
        if isinstance(v, torch.Generator):
            v.set_state(s)
        elif isinstance(v, torch.Tensor):
            # In place, on the target's device and dtype: an optimizer
            # may hold the tensor (SAC's log_alpha).
            with torch.no_grad():
                v.copy_(s)
        elif isinstance(v, int) and not isinstance(v, bool):
            setattr(target, f.name, int(s))
        elif dataclasses.is_dataclass(v):
            _restore(s, v)
        else:
            v.load_state_dict(s)
    return target


def save(path: str, state) -> str:
    """Write `state` (a dataclass such as `algos.ppo.TrainState`,
    `algos.npg.NPGState` or `algos.sac.SACState`) to `path`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(_state_dict(state), path)
    return path


def restore(path: str, target):
    """Load `path` into `target` (same fields; it supplies the modules,
    tensors, their devices and dtypes, as the JAX package's target
    pytree does) and return it."""
    return _restore(torch.load(path, map_location="cpu", weights_only=True),
                    target)


def restore_module(path: str, module, field: str = "module"):
    """Load only the `field` module of the checkpoint at `path` into
    `module` (an evaluation's policy; the JAX package restores the
    params alone) and return it."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    module.load_state_dict(saved[field])
    return module


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
