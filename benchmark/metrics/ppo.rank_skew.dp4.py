"""ppo.rank_skew.dp4: how far the ranks' rollouts part in an iteration,
(`rollout_ms_max` - `rollout_ms_min`) / `rollout_ms_max` (the port's
own timings: each rank's rollout ms reduced over the env axis), mean
over the window's iterations (`lib/laps.iterations`).  Nothing where
the program reduces no rollout time."""
from benchmark.lib import laps

TIMINGS = True


def read(rec):
    return laps.mean([(t["rollout_ms_max"] - t["rollout_ms_min"])
                      / t["rollout_ms_max"]
                      for t in laps.iterations(rec, "rollout_ms_max")])
