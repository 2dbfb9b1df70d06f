"""The rollout kind checks a fixed stretch of units counted from set-up
(`check_at` in the cell's file), whenever the window ends: the checked
rows do not depend on how many units the window ran.  `VectorEnv.step`
is replaced by a stand-in, wrapped as the kind's `FAULTS` wrap it, so no
physics runs: each unit takes 5 ms, adds 1 to `step_count` and
`nan_resets` and its actions' sum to `obs`, so a kept state tells which
unit made it."""
import time

import pytest
import torch

from benchmark.lib import drive, harness, spec, trace

CELLS = sorted(w["name"] for w in spec.benchmark()["workloads"]
               if spec.Cell(w["name"]).traffic["kind"] == "rollout")
SEED = 2**31 + 11


@pytest.fixture
def stand_in():
    """The stand-in step; yields the host clock of each of its calls."""
    calls = []

    def make(orig):
        def step(self, state, actions):
            time.sleep(0.005)
            calls.append(time.perf_counter())
            return state.replace(
                step_count=state.step_count + 1,
                nan_resets=state.nan_resets + 1,
                obs=state.obs + actions.sum(-1, keepdim=True))
        return step
    p = trace.Patches()
    p.wrap("mj_envs_torch.parallel.vector:VectorEnv.step", make)
    try:
        yield calls
    finally:
        p.undo()


def small(name):
    cell = spec.Cell(name)
    cell.traffic["num_envs"] = min(4, int(cell.traffic["num_envs"]))
    drive.apply_options(cell.config)
    return cell


def checked_after(cell, window_units):
    """A drive whose window ran `window_units` units, and its check."""
    kind = spec.kind("rollout")
    d = kind.Drive(cell.config, cell.traffic, SEED, "cpu", cell.limits)
    d.setup()
    d.mark()
    for _ in range(window_units):
        d.unit()
    return d, kind.Check(d, cell, SEED)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("ends", ["before", "at", "after"])
def test_the_check_keeps_its_units_wherever_the_window_ends(
        stand_in, name, ends):
    cell = small(name)
    at, n = cell.limits["check_at"], cell.limits["check_units"]
    window = {"before": at // 2, "at": at - 1, "after": at + 7}[ends]
    d, _ = checked_after(cell, window)
    assert d.units == max(at, window + 1) == len(stand_in)
    made_by = [int((post.step_count - d.initial.step_count)[0])
               for _, _, post in d.checked]
    assert made_by == list(range(at - n + 1, at + 1))
    for pre, _, post in d.checked:
        assert torch.equal(post.step_count, pre.step_count + 1)


@pytest.mark.parametrize("name", CELLS)
def test_untimed_units_are_outside_the_window(stand_in, monkeypatch, name):
    windows, real = [], harness.window

    def window(unit, seconds, dev):
        t0, w = real(unit, seconds, dev)
        windows.append((t0, w))
        return t0, w
    monkeypatch.setattr(harness, "window", window)
    kind = spec.kind("rollout")
    monkeypatch.setattr(kind.Check, "numbers",
                        lambda self, device, control=False: {})
    cell = small(name)
    r = harness.run(name, SEED, 0.05, False, device="cpu",
                    overrides={"num_envs": cell.traffic["num_envs"]})
    (t0, w), = windows
    b, at = cell.traffic["num_envs"], cell.limits["check_at"]
    assert w["units"] < at - 1, "the window has to end before check_at"
    assert r["attempted"] == w["env_steps"] == w["units"] * b
    assert r["failed"] == w["units"] * b       # the window's units alone
    end = t0 + w["seconds"]
    assert len(stand_in) == at
    assert sum(t > end for t in stand_in) == at - 1 - w["units"]


def _rows(chk):
    out = []
    for st in [chk.start] + [x for s in chk.steps for x in s]:
        if isinstance(st, torch.Tensor):
            out.append(st)
        else:
            st.map(lambda x: out.append(x) or x)
    return out


@pytest.mark.parametrize("name", CELLS)
def test_two_windows_check_the_same_rows(stand_in, name):
    cell = small(name)
    _, short = checked_after(cell, 10)
    _, long = checked_after(cell, 30)
    a, b = _rows(short), _rows(long)
    assert len(a) == len(b) and len(short.steps) \
        == cell.limits["check_units"]
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
