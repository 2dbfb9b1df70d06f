"""Batched environments stepped in sequential chunks
(`mj_envs_tpu/parallel/vector.py`).

Why chunks: the Newton solver's loop runs until every env in its batch
has converged, so one slow env makes the whole batch pay its extra
iterations.  Stepping the batch in chunks of `chunk_size` envs lets each
chunk's solver exit on its own.  Chunking changes only the schedule, not
per-env math.

With a mesh (`parallel/distributed.make_mesh`) each rank holds and steps
only its rows of the global batch, `process_local_batch`'s
[offset, offset + local), in chunks of `chunk_size`.  The global batch
is then the ranks' chunks in row order, and each rank advances the reset
generator past the other ranks' chunks as it goes, so that its rows are
those of a single-process VectorEnv with the same chunks bit for bit (a
chunk_size that divides the per-rank batch).
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


def _cat(states):
    return states[0].map(lambda *xs: torch.cat(xs, dim=0), *states[1:])


def _run_chunks(fn, state: EnvState, actions: torch.Tensor, plan, *extra,
                skip: Optional[Callable] = None):
    """fn(state rows, actions rows, *extra) over `plan`, a list of
    (start, stop, mine) row ranges of the global batch; a range that is
    not mine goes to skip(stop - start) instead (the generator's
    bookkeeping), mine are rows of `state` from the first of them on.
    The results are joined again: an EnvState or a tuple of them."""
    base = next(i for i, _, mine in plan if mine)
    outs = []
    for i, j, mine in plan:
        if not mine:
            skip(j - i)
        elif (i, j) == (base, base + state.batch):
            outs.append(fn(state, actions, *extra))
        else:
            a, b = i - base, j - base
            outs.append(fn(state.map(lambda x: x[a:b]), actions[a:b],
                           *extra))
    if len(outs) == 1:
        return outs[0]
    if isinstance(outs[0], tuple):
        return tuple(_cat(sts) for sts in zip(*outs))
    return _cat(outs)


def _chunked(fn: Callable, state: EnvState, actions: torch.Tensor,
             chunk_size: int, *extra):
    """fn(state, actions, *extra) over chunks of the envs, its results
    joined again: an EnvState or a tuple of them."""
    return _run_chunks(fn, state, actions,
                       [(i, j, True) for i, j in _chunks(state.batch,
                                                          chunk_size)],
                       *extra)


def shard_plan(num_envs: int, chunk_size: int, local: int, offset: int):
    """The chunks of a global batch of `num_envs` split into shards of
    `local` rows, each shard in chunks of `chunk_size`: (start, stop,
    mine) in row order, mine for the shard at `offset`."""
    return [(s + i, s + j, s == offset) for s in range(0, num_envs, local)
            for i, j in _chunks(local, chunk_size)]


class VectorEnv:
    """`num_envs` lockstep copies of `env`, stepped in chunks of
    `chunk_size` (default 512; 0 disables chunking).  Resets draw from a
    `torch.Generator` on the env's device, seeded by `reset(seed)`.

    This rank holds rows [offset, offset + local) of the `num_envs`: all
    of them without a mesh, its shard's with one (module docstring).
    `plan` is the global batch's chunks (`shard_plan`)."""

    def __init__(self, env: AdroitEnv, num_envs: int, mesh=None,
                 env_axis: str = "env", chunk_size: int = 512):
        self.env = env
        self.num_envs = num_envs
        self.mesh = mesh
        self.env_axis = env_axis
        self.chunk_size = chunk_size
        self.generator: Optional[torch.Generator] = None
        self.local, self.offset = num_envs, 0
        if mesh is not None:
            from .distributed import process_local_batch
            self.local, self.offset = process_local_batch(mesh, num_envs,
                                                          env_axis)
        self.plan = shard_plan(num_envs, chunk_size, self.local,
                               self.offset)

    def reset(self, seed: int = 0) -> EnvState:
        self.generator = self.env.generator(seed)
        var = self.env._reset_var(self.env.base_var(self.num_envs),
                                  self.generator)
        lo, hi = self.offset, self.offset + self.local
        return self.env.reset_from_var(
            type(var)(**{f: t[lo:hi] for f, t in var.items()}))

    def step(self, state: EnvState, actions: torch.Tensor) -> EnvState:
        """Auto-resetting batched step (the RL rollout primitive)."""
        if self.generator is None:
            raise RuntimeError("call reset(seed) before step")
        return step_rows(self.env, self.env.step_auto_reset, state,
                         actions, self.plan, self.generator)

    def step_no_reset(self, state: EnvState,
                      actions: torch.Tensor) -> EnvState:
        """Plain batched step (parity testing / fixed-length eval)."""
        return _chunked(self.env.step, state, actions, self.chunk_size)


def step_rows(env: AdroitEnv, fn: Callable, state: EnvState,
              actions: torch.Tensor, plan, generator: torch.Generator):
    """fn(rows, actions, generator), an auto-resetting step, over this
    rank's chunks of `plan`; the generator skips the reset draws of the
    other ranks' chunks in their turn."""
    return _run_chunks(fn, state, actions, plan, generator,
                       skip=lambda n: env.skip_reset_draws(n, generator))


def random_actions(generator: torch.Generator, num_envs: int, nu: int,
                   device, dtype=torch.float32) -> torch.Tensor:
    """Uniform actions in [-1, 1)."""
    u = torch.rand(num_envs, nu, generator=generator, device=device,
                   dtype=dtype)
    return 2.0 * u - 1.0
