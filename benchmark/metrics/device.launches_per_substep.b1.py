"""device.launches_per_substep.b1: device operations in the profiled
slice (one chunk's env step) over its substeps."""
from benchmark.lib import readers as R

PROFILE = True
COUNTS = {"pipeline.step": R.PIPELINE_STEP}
read = R.launches_per_substep
