"""step_ms: the window's time over its env steps, in ms."""
from benchmark.lib.readers import ms_per_unit as read  # noqa: F401
