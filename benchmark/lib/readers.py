"""What the metric readers (`metrics/<name>.py`) share.  A reader that
finds nothing to read returns None, and the metric is left out of the
result line."""
from __future__ import annotations

from typing import Optional

# Module attributes the port calls through (the spans and counts).
STEP_AUTO_RESET = "mj_envs_torch.envs.base:AdroitEnv.step_auto_reset"
PIPELINE_STEP = "mj_envs_torch.physics.pipeline:step"
COLLIDE = "mj_envs_torch.physics.collision.driver:collide"


def rate(rec) -> Optional[float]:
    """All env-steps of the window over its whole time."""
    w = rec.window
    return w["env_steps"] / w["seconds"] if w.get("seconds") else None


def ms_per_unit(rec) -> Optional[float]:
    """The window's whole time over its units, in ms."""
    w = rec.window
    return 1e3 * w["seconds"] / w["units"] if w.get("units") else None


def newton_iters(rec) -> Optional[float]:
    """Newton iterations a chunk substep: the port's launches of the
    linesearch-cost kernel (one an iteration) over `pipeline.step` calls
    in the window."""
    n = rec.calls.get("pipeline.step", 0)
    return rec.launches.get("linesearch_cost", 0) / n if n else None


def idle_share(rec) -> Optional[float]:
    """1 - (union of device-operation intervals) / (the slice's wall)."""
    p = rec.profile
    if not p or p["window_s"] <= 0:
        return None
    return 1.0 - p["busy_s"] / p["window_s"]


def launches_per_substep(rec) -> Optional[float]:
    """Device operations in the profiled slice over its substeps."""
    p = rec.profile
    n = p["calls"].get("pipeline.step", 0) if p else 0
    return p["device_ops"] / n if n else None


def k_roofline(rec) -> Optional[float]:
    """Sum of the K1-K6 launches' bounds over their device time in the
    profiled slice, in %; nothing where the kernels found in the trace
    are not the launches counted."""
    p = rec.profile
    if not p or not p["kernel_events"] \
            or p["kernel_events"] != p["bound_launches"]:
        return None
    return 100.0 * p["bound_s"] / p["kernel_s"]
