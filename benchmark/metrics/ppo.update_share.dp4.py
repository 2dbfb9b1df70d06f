"""ppo.update_share.dp4: the update's share of an iteration on rank 0,
the window's `update_ms` over the sum of its laps (`lib/laps.LAPS`:
rollout, GAE, the wait for the slowest rank, the gather, the update), over the window's iterations
(`lib/laps.iterations`).  Nothing where the program laps no update."""
from benchmark.lib import laps

TIMINGS = True


def read(rec):
    its = laps.iterations(rec, "update_ms")
    whole = sum(t.get(k, 0.0) for t in its for k in laps.LAPS)
    return sum(t["update_ms"] for t in its) / whole if whole else None
