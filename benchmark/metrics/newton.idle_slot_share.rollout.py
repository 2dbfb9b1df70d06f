"""newton.idle_slot_share.rollout: the share of the Newton loop's env
slots spent on envs that had converged, over the window: 1 -
`newton.env_iters` / `newton.slots` (the program's counters,
`mj_envs_torch.trace`; the loop runs the whole chunk until its slowest
env converges).  Nothing where the program has no tracer."""
try:
    from mj_envs_torch import trace
except ImportError:          # a port without the tracer
    pass
else:
    trace.enable()           # a traced run: on from set-up onward


def read(rec):
    slots = rec.launches.get("newton.slots", 0)
    return 1.0 - rec.launches.get("newton.env_iters", 0) / slots \
        if slots else None
