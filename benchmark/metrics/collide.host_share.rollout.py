"""collide.host_share.rollout: the host's time in the program's span
`physics.collide` over its time in `physics.substep` in the window
(`mj_envs_torch.trace`).  The program's spans do not synchronize, but
in a traced run the span also holds `collide_share.rollout`'s
synchronizes at both ends of `collide` and the tracer's count of the
synchronizing operations made inside it.  Nothing where the program
has no tracer."""
try:
    from mj_envs_torch import trace
except ImportError:          # a port without the tracer
    pass
else:
    trace.enable()           # a traced run: on from set-up onward


def read(rec):
    whole = rec.launches.get("span.physics.substep.ns", 0)
    return rec.launches.get("span.physics.collide.ns", 0) / whole \
        if whole else None
