"""setup.kernel_library_s: seconds of the process in the program's span
`setup.kernel_library` (the kernel library's `nvcc` build on a
checkout's first run, or its load; `mj_envs_torch.trace`), all of it
set-up.  Nothing where the program has no tracer."""
try:
    from mj_envs_torch import trace
except ImportError:          # a port without the tracer
    trace = None
else:
    trace.enable()           # a traced run: on from set-up onward


def read(rec):
    ns = trace.counters.get("span.setup.kernel_library.ns") if trace \
        else None
    return None if ns is None else ns * 1e-9
