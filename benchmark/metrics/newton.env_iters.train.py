"""newton.env_iters.train: Newton iterations an env runs in a solve, over
the window (the program's counters `newton.env_iters` / `newton.solves`,
`mj_envs_torch.trace`; `newton_iters.train` counts the batch's
iterations instead).  Nothing where the program has no tracer."""
try:
    from mj_envs_torch import trace
except ImportError:          # a port without the tracer
    pass
else:
    trace.enable()           # a traced run: on from set-up onward


def read(rec):
    solves = rec.launches.get("newton.solves", 0)
    return rec.launches.get("newton.env_iters", 0) / solves \
        if solves else None
