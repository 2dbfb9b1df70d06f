"""device.idle_share.rollout: 1 - busy / wall of the profiled slice (one
chunk's env step)."""
from benchmark.lib import readers as R

PROFILE = True
read = R.idle_share
