"""The window's arithmetic: whole units until the time has passed, and a
rate over all the window's work and all its time."""
import time

import torch

from benchmark.lib import harness, readers, trace


class Sleepy:
    def __init__(self, dt, steps):
        self.dt, self.steps, self.n = dt, steps, 0

    def __call__(self):
        time.sleep(self.dt)
        self.n += 1
        return self.steps


def test_whole_units_until_the_time_has_passed():
    unit = Sleepy(0.05, 100)
    t0, w = harness.window(unit, 0.12, torch.device("cpu"))
    assert w["units"] == unit.n == 3          # the unit that crosses 0.12 ends it
    assert w["env_steps"] == 300
    assert w["seconds"] >= 0.15


def test_rate_and_time_per_step_over_the_whole_window():
    rec = trace.Recorder("cpu")
    rec.window = dict(units=4, env_steps=4 * 512, seconds=2.0)
    assert readers.rate(rec) == 1024.0
    assert readers.ms_per_unit(rec) == 500.0


def test_one_slow_unit_moves_the_rate():
    # A median of units would hide the stall; the window's rate does not.
    times = iter([0.02, 0.02, 0.3, 0.3])

    def unit():
        time.sleep(next(times))
        return 10
    _, w = harness.window(unit, 0.5, torch.device("cpu"))
    assert w["units"] == 4
    rec = trace.Recorder("cpu")
    rec.window = w
    assert readers.rate(rec) <= 40 / 0.64
