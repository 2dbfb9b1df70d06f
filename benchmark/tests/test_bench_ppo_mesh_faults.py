"""Each of the kind `ppo_mesh`'s faults (`kinds/ppo_mesh.py` `FAULTS`)
reads `correct` false in its cell at a small size on the CPU, two gloo
ranks, every env restarting in the checked warm-up step: the last two
ranks' rows swapped in the gather (every rank), the last rank's reset
generator not skipping the other ranks' draws, the last rank's
optimizer step returning its state unchanged.  The sound run and the
worker's death: `test_bench_ppo_mesh.py`."""
import pytest
import torch

from benchmark.lib import faults, harness, spec

CELL = "hammer.ppo.4x1024"
SMALL = {"ranks": 2, "num_envs": 8, "n_steps": 1, "n_minibatches": 2,
         "phase_range": [199, 200]}
# what each fault must move (the run is not correct in any case)
MOVES = {"swapped_gather": "policy_err", "unskipped_draws": "draws_differ",
         "skipped_step": "ranks_params_differ"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Rank 0 on one thread, as each spawned rank on the CPU is."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fault", sorted(spec.kind("ppo_mesh").FAULTS))
def test_fault_is_caught(fault):
    with faults.planted(fault, "ppo_mesh"):
        r = harness.run(CELL, 2**31 + 11, 0.1, False, device="cpu",
                        overrides=SMALL)
    assert not r["correct"], r["checked"]
    c = r["checked"][MOVES[fault]]
    assert c["value"] > c["limit"], c
