"""Sequence replay buffer for PlaNet, on the host in numpy (a copy of
`mj_envs_tpu/algos/replay.py`, so that the port imports nothing of the
JAX package).

The Kaixhin/PlaNet `memory.ExperienceReplay` the reference uses
(`train.py:105-123`): a ring of (observation, action, reward,
nonterminal) with bit-depth-quantized uint8 images and chunked sequence
sampling; a chunk may wrap the ring but never straddles the write head.
Draws come from one `np.random.default_rng(seed)` in the JAX package's
order (each start, with its rejections, then the dequantization noise),
so the two packages sample the same batches bit for bit.  A full-size
buffer (10^6 frames of 64x64x3) is 12.3 GB of host memory, committed as
it is written.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def quantize_obs(obs_float_0_255: np.ndarray, bit_depth: int) -> np.ndarray:
    """float [0, 255] -> uint8 storage at `bit_depth` bits (PlaNet's
    postprocess); the float is truncated to uint8 first, not rounded."""
    x = np.floor_divide(obs_float_0_255.astype(np.uint8),
                        2 ** (8 - bit_depth)) * 2 ** (8 - bit_depth)
    return x.astype(np.uint8)


def dequantize_obs(obs_u8: np.ndarray, bit_depth: int,
                   rng: np.random.Generator) -> np.ndarray:
    """uint8 -> float32 in [-0.5, 0.5] plus dequantization noise
    U[0, 1) / 2^bit_depth (PlaNet's preprocess)."""
    x = obs_u8.astype(np.float32)
    x = np.floor_divide(x, 2 ** (8 - bit_depth)) / (2 ** bit_depth) - 0.5
    x += rng.uniform(size=x.shape).astype(np.float32) / (2 ** bit_depth)
    return x


class ExperienceReplay:
    def __init__(self, size: int, obs_shape, action_size: int,
                 bit_depth: int = 5, seed: int = 0,
                 symbolic: bool = False):
        self.size = size
        self.symbolic = symbolic
        self.bit_depth = bit_depth
        self.observations = np.zeros((size,) + tuple(obs_shape),
                                     np.float32 if symbolic else np.uint8)
        self.actions = np.zeros((size, action_size), np.float32)
        self.rewards = np.zeros((size,), np.float32)
        self.nonterminals = np.zeros((size,), np.float32)
        self.idx = 0
        self.full = False
        self.steps = 0
        self.episodes = 0
        self.rng = np.random.default_rng(seed)

    def append(self, obs, action, reward, done):
        if self.symbolic:
            self.observations[self.idx] = obs
        else:
            self.observations[self.idx] = quantize_obs(
                np.asarray(obs), self.bit_depth)
        self.actions[self.idx] = action
        self.rewards[self.idx] = reward
        self.nonterminals[self.idx] = 0.0 if done else 1.0
        self.idx = (self.idx + 1) % self.size
        self.full = self.full or self.idx == 0
        self.steps += 1
        self.episodes += int(done)

    def _valid_start(self, chunk: int) -> int:
        limit = self.size if self.full else self.idx
        while True:
            start = int(self.rng.integers(0, limit - chunk))
            idxs = np.arange(start, start + chunk) % self.size
            # reject a chunk that straddles the write head
            if not self.full or self.idx not in idxs[1:]:
                return start

    def sample(self, batch: int, chunk: int) -> Dict[str, np.ndarray]:
        """-> a dict of (chunk, batch, ...) arrays; images dequantized to
        [-0.5, 0.5] with noise (reference `train.py:26`)."""
        starts = [self._valid_start(chunk) for _ in range(batch)]
        idxs = np.stack([np.arange(s, s + chunk) % self.size
                         for s in starts], axis=1)     # (chunk, batch)
        obs = self.observations[idxs]
        if not self.symbolic:
            obs = dequantize_obs(obs, self.bit_depth, self.rng)
        return {
            "obs": obs,
            "actions": self.actions[idxs],
            "rewards": self.rewards[idxs],
            "nonterminals": self.nonterminals[idxs],
        }
