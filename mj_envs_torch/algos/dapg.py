"""Loader of the reference's pretrained DAPG policies, for the PyTorch
port (`mj_envs_tpu/algos/dapg.py`).

The four pickles (`mj_envs_vision/algos/dapg_pretrained/*.pickle`) hold
mjrl `gaussian_mlp.MLP` objects wrapping a torch `FCNetwork`
((obs - in_shift) / (in_scale + 1e-8) -> tanh MLP (32, 32) -> * out_scale
+ out_shift) and a state-independent log_std.  mjrl is not installed, so
an Unpickler that substitutes attribute-bag stubs for mjrl's classes
extracts the weights (this module's own copy of the JAX package's, which
uses only pickle, numpy and torch).  `make_policy` turns them into the
deterministic action on the card.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from .ppo import require_device

# Where the JAX package looks for the pickles (`load_policy`'s default
# root there): the reference checkout's pretrained policies.
DEFAULT_ROOT = os.path.join(os.sep, "root", "reference", "mj_envs_vision",
                            "algos", "dapg_pretrained")


class _Stub:
    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        self.__dict__["_state"] = state


_made: Dict[str, type] = {}


def _make_stub(module: str, name: str) -> type:
    key = f"{module}.{name}"
    if key not in _made:
        _made[key] = type(name, (_Stub,), {"_qualname": key})
    return _made[key]


class _MjrlUnpickler(pickle.Unpickler):
    """Unpickles mjrl policy pickles without mjrl installed: mjrl classes
    become attribute-bag stubs; the removed torch-1.x thnn backend hook is
    stubbed; torch tensors load normally."""

    def find_class(self, module, name):
        if module.startswith("mjrl"):
            return _make_stub(module, name)
        if module == "torch.nn.backends.thnn":
            return lambda: None
        return super().find_class(module, name)


def _state(obj) -> Dict[str, Any]:
    return obj.__dict__.get("_state", obj.__dict__)


def _t2np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return np.asarray(x.detach().numpy(), np.float64)
    return np.asarray(x, np.float64)


def load_dapg_params(path: str) -> Dict[str, Any]:
    """-> dict with 'layers' [(w (out, in), b), ...], 'log_std',
    'in_shift', 'in_scale', 'out_shift', 'out_scale', 'obs_dim',
    'act_dim', 'nonlinearity' ("tanh" or "relu"); arrays in float64."""
    with open(path, "rb") as f:
        mlp = _MjrlUnpickler(f).load()
    st = _state(mlp)
    net = _state(st["model"])

    fc = net["_modules"]["fc_layers"]._modules
    layers = []
    for idx in sorted(fc.keys(), key=int):
        lin = fc[idx]
        layers.append((_t2np(lin._parameters["weight"]),
                       _t2np(lin._parameters["bias"])))

    # mjrl pickles store the nonlinearity as the torch function object
    # (e.g. <built-in method tanh>), not a string: normalize by name.
    nonlin = net.get("nonlinearity", "tanh")
    nonlin = getattr(nonlin, "__name__", str(nonlin)).lower()
    if "tanh" in nonlin:
        nonlin = "tanh"
    elif "relu" in nonlin:
        nonlin = "relu"
    else:
        raise ValueError(f"unknown mjrl nonlinearity {nonlin!r}")
    return {
        "layers": layers,
        "log_std": _t2np(st["log_std"]),
        "in_shift": _t2np(net["in_shift"]),
        "in_scale": _t2np(net["in_scale"]),
        "out_shift": _t2np(net["out_shift"]),
        "out_scale": _t2np(net["out_scale"]),
        "obs_dim": int(net["obs_dim"]),
        "act_dim": int(net["act_dim"]),
        "nonlinearity": nonlin,
    }


def make_policy(params: Dict[str, Any], device="cuda",
                dtype=torch.float32) -> Callable[[torch.Tensor], torch.Tensor]:
    """The deterministic action (the reference's evaluation path: act =
    mean) on `device` (the card unless the caller asks for the CPU), for
    obs of shape (..., obs_dim)."""
    device = require_device(device)
    as_t = lambda a: torch.as_tensor(np.asarray(a), device=device,
                                     dtype=dtype)
    ws = [(as_t(w), as_t(b)) for w, b in params["layers"]]
    in_shift, in_scale = as_t(params["in_shift"]), as_t(params["in_scale"])
    out_shift = as_t(params["out_shift"])
    out_scale = as_t(params["out_scale"])
    nonlin = torch.tanh if params["nonlinearity"] == "tanh" else torch.relu

    def act(obs: torch.Tensor) -> torch.Tensor:
        x = (obs - in_shift) / (in_scale + 1e-8)
        for w, b in ws[:-1]:
            x = nonlin(x @ w.T + b)
        w, b = ws[-1]
        x = x @ w.T + b
        return x * out_scale + out_shift

    return act


def load_policy(task: str, device="cuda", dtype=torch.float32,
                root: str = DEFAULT_ROOT) -> Tuple[Callable, Dict]:
    params = load_dapg_params(os.path.join(root, f"{task}-v0.pickle"))
    return make_policy(params, device, dtype), params
