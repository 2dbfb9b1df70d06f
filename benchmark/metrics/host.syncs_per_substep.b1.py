"""host.syncs_per_substep.b1: synchronizing CUDA operations the
program makes inside its span `env.step` (physics, obs, reward, the
in-step reset and the merge), over its physics substeps, in the window
(`mj_envs_torch.trace`, PyTorch's sync debug mode counted).  Nothing
where the program has no tracer."""
try:
    from mj_envs_torch import trace
except ImportError:          # a port without the tracer
    pass
else:
    trace.enable()           # a traced run: on from set-up onward


def read(rec):
    n = rec.launches.get("span.physics.substep.n", 0)
    return rec.launches.get("span.env.step.syncs", 0) / n if n else None
