"""What every traffic kind (`kinds/<kind>.py`) shares: the draws from the
seed, the staggered episode phases, the policy's weights and the
program's options.  Every seed gets the same sizes; the seed changes
only the draws.
"""
from __future__ import annotations

import hashlib
import math
import os
from typing import Dict

import torch


def apply_options(config: dict) -> None:
    """Run the program as the configuration states: each of its
    `program_env` entries (an option the program reads from the
    environment) set before the program runs."""
    for key, value in config.get("program_env", {}).items():
        os.environ[key] = str(value)


def sub_seed(seed: int, name: str) -> int:
    """A seed for one stream of draws, from the run's seed and the
    stream's name (any whole number in, < 2**63 out)."""
    h = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(device, seed: int, name: str) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, name))


def uniform_actions(gen: torch.Generator, num_envs: int, nu: int,
                    device) -> torch.Tensor:
    """Uniform actions in [-1, 1) (a copy of the port's
    `parallel.vector.random_actions`)."""
    u = torch.rand(num_envs, nu, generator=gen, device=device,
                   dtype=torch.float32)
    return 2.0 * u - 1.0


def staggered(state, cap: int, gen: torch.Generator):
    """`state` with each env's step_count drawn uniformly in [0, cap)."""
    sc = torch.randint(0, cap, (state.batch,), generator=gen,
                       device=state.step_count.device, dtype=torch.int32)
    return state.replace(step_count=sc)


def policy_weights(seed: int, obs_dim: int, act_dim: int, hidden,
                   device) -> Dict[str, torch.Tensor]:
    """The actor-critic's weights by the port's parameter names, drawn
    on `device` from the seed (float32): N(0, 1) / sqrt(fan_in) times
    sqrt(2) in the hidden layers, 0.01 in the actor's last layer, 1.0 in
    the critic's; zero biases and log_std."""
    gen = generator(device, seed, "weights")
    out = {}
    for head, last_gain in (("actor", 0.01), ("critic", 1.0)):
        sizes = [obs_dim, *hidden, act_dim if head == "actor" else 1]
        for i in range(len(sizes) - 1):
            fan_in, fan_out = sizes[i], sizes[i + 1]
            gain = last_gain if i == len(sizes) - 2 else math.sqrt(2.0)
            w = torch.randn(fan_out, fan_in, generator=gen, device=device)
            out[f"{head}.{i}.weight"] = w * (gain / math.sqrt(fan_in))
            out[f"{head}.{i}.bias"] = torch.zeros(fan_out, device=device)
    out["log_std"] = torch.zeros(act_dim, device=device)
    return out


def failures(before, after) -> int:
    """Env steps quarantined (nan_resets grew) or that dropped contacts
    (contact_clips grew) between two states of the same envs."""
    return int((after.nan_resets - before.nan_resets).sum().item()
               + (after.contact_clips - before.contact_clips).sum().item())
