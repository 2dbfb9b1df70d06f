"""ppo.gather_ms.dp4: the port's own `timings["gather_ms"]` on rank 0
(the gathers of the trajectory, advantages and returns over the env
axis and the all-reduce of `nan_resets`; its host clock, the card
synchronized at both ends; the program laps the wait for the slowest
rank before it, apart, as `wait_ms`),
mean over the window's iterations (`lib/laps.iterations`).  Nothing
where the program laps no gather.  The traced run turns the program's
tracer on, so that its span `ppo.gather` and counter
`ppo.gather_bytes` are recorded (the kind prints the bytes of each
iteration)."""
from benchmark.lib import laps

try:
    from mj_envs_torch import trace
except ImportError:          # a port without the tracer
    pass
else:
    trace.enable()           # a traced run: on from set-up onward

TIMINGS = True


def read(rec):
    return laps.mean([t["gather_ms"]
                      for t in laps.iterations(rec, "gather_ms")])
