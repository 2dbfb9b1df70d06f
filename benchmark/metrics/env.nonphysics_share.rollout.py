"""env.nonphysics_share.rollout: 1 - (time in pipeline.step spans) /
(time in step_auto_reset spans): obs, reward, the chunk's in-step reset
and the merge."""
from benchmark.lib import readers as R

SPANS = {"step_auto_reset": R.STEP_AUTO_RESET,
         "pipeline.step": R.PIPELINE_STEP}


def read(rec):
    share = rec.span_share("pipeline.step", "step_auto_reset")
    return None if share is None else 1.0 - share
