"""Faults planted under the timed path, to show that the check fails
them (`tests/test_bench_faults.py` on the CPU, `calibrate.py --fault` on
the card).  Each is a context manager that patches the port at run time
and undoes the patch on exit.

A traffic kind's module (`kinds/<kind>.py`) plants its own under
`FAULTS` (the step that returns its state unchanged, half of the batch
left out); these two are the task env's and serve every kind:

* `altered`: an answer altered where it is produced (the env step's
  reward, 0.01 added);
* `merge`: the auto-reset merge keeps a restarted env's finished
  physics (its qpos, qvel, caches and obs), with the fresh episode's
  step count and drawn randomization.
"""
from __future__ import annotations

import contextlib

from . import spec, trace


def _altered(p):
    def make(orig):
        def step(self, state, action):
            st = orig(self, state, action)
            return st.replace(reward=st.reward + 0.01)
        return step
    p.wrap("mj_envs_torch.envs.base:AdroitEnv.step", make)


def _merge(p):
    def make(orig):
        def pair(self, state, action, generator):
            merged, st = orig(self, state, action, generator)
            return merged.replace(data=st.data, obs=st.obs), st
        return pair
    p.wrap("mj_envs_torch.envs.base:AdroitEnv._step_auto_reset_pair", make)


ENV_FAULTS = {"altered": _altered, "merge": _merge}


def names(kind: str):
    """The faults planted under a traffic kind."""
    return tuple(spec.kind(kind).FAULTS) + tuple(ENV_FAULTS)


@contextlib.contextmanager
def planted(name: str, kind: str):
    plant = {**spec.kind(kind).FAULTS, **ENV_FAULTS}.get(name)
    if plant is None:
        raise ValueError(f"no fault {name!r} for kind {kind!r}")
    p = trace.Patches()
    try:
        plant(p)
        yield
    finally:
        p.undo()
