"""newton_iters.train: Newton iterations a chunk substep (linesearch-cost
launches over pipeline.step calls in the window)."""
from benchmark.lib import readers as R

COUNTS = {"pipeline.step": R.PIPELINE_STEP}
read = R.newton_iters
