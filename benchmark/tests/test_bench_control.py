"""The control, on the card: the reference in float32 with TF32 matrix
products, put in the program's place, fails the cell's limits where the
program passes them (hammer at 64 envs, at the cell's `check_at`; the
PPO cell at 64 envs x 2 steps, one iteration after the warm-up).
The full readings, at the cells' own sizes, come from
`benchmark/calibrate.py`."""
import pytest

from benchmark.lib import check, drive, spec

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name,small", [
    ("hammer.rollout.4096", {"num_envs": 64}),
    ("hammer.ppo.1024", {"num_envs": 64, "n_steps": 2}),
])
def test_control_fails_where_the_program_passes(card, name, small):
    cell = spec.Cell(name)
    cell.traffic.update(small)
    drive.apply_options(cell.config)
    kind = spec.kind(cell.traffic["kind"])
    for seed in (11, 12, 13):
        d = kind.Drive(cell.config, cell.traffic, seed, card, cell.limits)
        d.setup()
        d.mark()
        d.unit()
        d.close()
        chk = kind.Check(d, cell, seed)
        ok, checked = check.judge(chk.numbers(card), cell.limits["limits"])
        assert ok, checked
        ok, checked = check.judge(chk.numbers(card, control=True),
                                  cell.limits["limits"])
        assert not ok, checked
