"""Batched environments stepped in sequential chunks
(`mj_envs_tpu/parallel/vector.py`).

Why chunks: the Newton solver's loop runs until every env in its batch
has converged, so one slow env makes the whole batch pay its extra
iterations.  Stepping the batch in chunks of `chunk_size` envs lets each
chunk's solver exit on its own.  Chunking changes only the schedule, not
per-env math.  The mesh/sharding arguments of the JAX VectorEnv belong
to the distributed slice of the port.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..envs.base import AdroitEnv, EnvState


def _chunks(B: int, chunk_size: int):
    """Chunk bounds: one chunk when B is not a multiple of (or not larger
    than) chunk_size, as `chunked_vmap` falls back to plain vmap."""
    if chunk_size <= 0 or B <= chunk_size or B % chunk_size:
        return [(0, B)]
    return [(i, i + chunk_size) for i in range(0, B, chunk_size)]


def _chunked(fn: Callable, state: EnvState, actions: torch.Tensor,
             chunk_size: int, *extra) -> EnvState:
    parts = _chunks(state.batch, chunk_size)
    if len(parts) == 1:
        return fn(state, actions, *extra)
    outs = [fn(state.map(lambda x: x[i:j]), actions[i:j], *extra)
            for i, j in parts]
    return outs[0].map(lambda *xs: torch.cat(xs, dim=0), *outs[1:])


class VectorEnv:
    """`num_envs` lockstep copies of `env`, stepped in chunks of
    `chunk_size` (default 512; 0 disables chunking).  Resets draw from a
    `torch.Generator` on the env's device, seeded by `reset(seed)`."""

    def __init__(self, env: AdroitEnv, num_envs: int, chunk_size: int = 512):
        self.env = env
        self.num_envs = num_envs
        self.chunk_size = chunk_size
        self.generator: Optional[torch.Generator] = None

    def reset(self, seed: int = 0) -> EnvState:
        self.generator = self.env.generator(seed)
        return self.env.reset(self.num_envs, self.generator)

    def step(self, state: EnvState, actions: torch.Tensor) -> EnvState:
        """Auto-resetting batched step (the RL rollout primitive)."""
        if self.generator is None:
            raise RuntimeError("call reset(seed) before step")
        return _chunked(self.env.step_auto_reset, state, actions,
                        self.chunk_size, self.generator)

    def step_no_reset(self, state: EnvState,
                      actions: torch.Tensor) -> EnvState:
        """Plain batched step (parity testing / fixed-length eval)."""
        return _chunked(self.env.step, state, actions, self.chunk_size)


def random_actions(generator: torch.Generator, num_envs: int, nu: int,
                   device, dtype=torch.float32) -> torch.Tensor:
    """Uniform actions in [-1, 1)."""
    u = torch.rand(num_envs, nu, generator=generator, device=device,
                   dtype=dtype)
    return 2.0 * u - 1.0
