"""Measure the floors behind the learner tests' tolerances: the worst
error over seeds 0, 1 and 2 of each quantity the tests bound.

    JAX_PLATFORMS=cpu python tests/measure_torch_learner_floors.py \
        [networks] [ppo]

* networks: `test_torch_networks.py`, the actor-critic, log-prob and
  entropy against the JAX package in float64 and float32;
* ppo: `test_torch_ppo.py`, GAE, the loss and gradients, Adam, the whole
  update (float64, float32) and one door-v0 iteration (float64).

(Not collected by pytest: the name does not start with `test_`.)
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import conftest  # noqa: E402,F401  (JAX on the CPU, x64 as in the tests)
import torch  # noqa: E402

from measure_torch_f64_floors import show  # noqa: E402

SEEDS = (0, 1, 2)


def main():
    torch.set_num_threads(2)
    what = sys.argv[1:] or ["networks", "ppo"]
    if "networks" in what:
        import test_torch_networks as TN
        for dt in (torch.float64, torch.float32):
            show(f"networks {dt}", [TN.network_errors(s, dt) for s in SEEDS])
    if "ppo" in what:
        import test_torch_ppo as TP
        show("gae (float64)", [TP.gae_errors(s) for s in SEEDS])
        show("loss and gradients (float64)",
             [TP.loss_grad_errors(s) for s in SEEDS])
        show("adam, 6 steps (float64)",
             [dict(params=TP.adam_errors(s)) for s in SEEDS])
        for dt in (torch.float64, torch.float32):
            show(f"update 2 x 4 ({dt})",
                 [TP.update_errors(s, dt) for s in SEEDS])
        show("door-v0 iteration (float64)",
             [TP.iteration_errors(torch.float64, s) for s in SEEDS])


if __name__ == "__main__":
    main()
