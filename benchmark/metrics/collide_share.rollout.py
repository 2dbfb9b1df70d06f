"""collide_share.rollout: time in collide spans / time in pipeline.step
spans."""
from benchmark.lib import readers as R

SPANS = {"pipeline.step": R.PIPELINE_STEP, "collide": R.COLLIDE}


def read(rec):
    return rec.span_share("collide", "pipeline.step")
