"""k1_k6_roofline.rollout: the K1-K6 launches' bounds over their device
time in the profiled slice (one chunk's env step), in % (`lib/bounds.py`)."""
from benchmark.lib import readers as R

PROFILE = True
read = R.k_roofline
