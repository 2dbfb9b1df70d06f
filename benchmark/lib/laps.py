"""What the readers of the trainer's laps share (`timings`, one dict an
iteration of the window; `mj_envs_torch/algos/ppo.py`)."""
from __future__ import annotations

from typing import List

# An iteration's laps, one after another: together its whole time.
LAPS = ("rollout_ms", "gae_ms", "wait_ms", "gather_ms", "update_ms")


def iterations(rec, key: str) -> List[dict]:
    """The window's timed iterations that hold `key`, less the first
    where the run profiled slices (they lie in the first iteration and
    slow rank 0's rollout alone)."""
    timed = [t for t in rec.timings or [] if key in t]
    return timed[1:] if getattr(rec, "profile", None) is not None else timed


def mean(values: List[float]):
    return sum(values) / len(values) if values else None
