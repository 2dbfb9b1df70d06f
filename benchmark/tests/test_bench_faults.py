"""A run with the timed path broken underneath reads `correct` false, once
for each fault a cell is checked for (`lib/faults.py` and each kind's
`FAULTS`), and a sound run reads it true: the harness on the CPU at a
small size, past its look for a card, with each cell's own limits.  One
chip: no exchange between chips to leave out.  `hammer.b1` has no half
of a batch; its single env restarts in a checked step only where its
drawn phase brings it there, so its merge is checked where it does.
With every env one step short of the cap, a sound run's restarts are
correct.  On the CPU a hammer step takes seconds, so each rollout cell
is checked here at unit 2 (the warm-up unit and the next), where the
card checks it at its `check_at`."""
import pytest
import torch

from benchmark.lib import drive, faults, harness, spec

SMALL = {
    "hammer.rollout.4096": {"num_envs": 4},
    "hammer.b1": {},
    "hammer.ppo.1024": {"num_envs": 4, "n_steps": 2, "n_minibatches": 2},
}
SKIP = {"hammer.b1": ("half_batch", "merge")}
EARLY = {"hammer.rollout.4096": {"check_at": 2}, "hammer.b1": {"check_at": 2}}
CASES = [(c, f) for c in sorted(SMALL)
         for f in faults.names(spec.Cell(c).traffic["kind"])
         if f not in SKIP.get(c, ())]


@pytest.fixture(autouse=True)
def early_check(monkeypatch):
    """Each cell as BENCHMARK.json has it, its check at `EARLY`'s unit."""
    class Cell(spec.Cell):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.limits.update(EARLY.get(self.name, {}))
    monkeypatch.setattr(spec, "Cell", Cell)


@pytest.fixture
def near_cap(monkeypatch):
    """Every env's drawn phase one step short of the episode cap, so
    that every env restarts in the warm-up step that the check holds."""
    def staggered(state, cap, gen):
        return state.replace(step_count=torch.full_like(
            state.step_count, cap - 1))
    monkeypatch.setattr(drive, "staggered", staggered)


def run(cell, fault=None, seed=2**31 + 7):
    small = SMALL[cell]
    if fault is None:
        return harness.run(cell, seed, 0.1, False, device="cpu",
                           overrides=small)
    with faults.planted(fault, spec.Cell(cell).traffic["kind"]):
        return harness.run(cell, seed, 0.1, False, device="cpu",
                           overrides=small)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checked"]
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(cell, fault, request):
    if fault == "merge":
        request.getfixturevalue("near_cap")
    r = run(cell, fault)
    assert not r["correct"], r["checked"]


@pytest.mark.parametrize("cell", ["hammer.rollout.4096", "hammer.b1"])
def test_restarts_are_correct(cell, near_cap):
    r = run(cell)
    assert r["correct"], r["checked"]
    assert r["checked"]["reset_err.max"]["value"] is not None
