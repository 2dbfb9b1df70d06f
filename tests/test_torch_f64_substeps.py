"""One float64 substep (`forward_core` and `step`) of each task, the port
against the JAX package's float64 path, from states 10 substeps after a
reset (CPU).  The helpers, the measured floors and the bounds are in
`test_torch_f64.py`.
"""
import pytest

from test_torch_f64 import (SUBSTEP_BOUNDS, TASKS, hold,  # noqa: F401
                            one_thread, substep_errors)


@pytest.mark.parametrize("task", TASKS)
def test_substep_matches_jax_f64(task):
    hold(substep_errors(task, 0), SUBSTEP_BOUNDS[task])
