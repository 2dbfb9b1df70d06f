"""The port's CLIs on short real rollouts, on the CPU: each of
`run_eval`'s four policy paths (`mj_envs_torch/utils/eval.py`: the DAPG
policy of a synthetic mjrl pickle, a PPO checkpoint of the port, the CNN
policy on pixels, PlaNet) and `visualize`'s three policy kinds (a DAPG
pickle, a PPO checkpoint, a PlaNet checkpoint with its sizes from
--config_path), 2 steps each: the artifacts `tests/test_cli.py` names,
their gifs holding the rollout's frames (count and size).  The stubbed protocol
tests are in `test_torch_cli.py`.
"""
import json
import os

import pytest
import torch
from PIL import Image

from chip_smoke import write_mjrl_pickle
from mj_envs_torch import envs as tenvs
from mj_envs_torch import visualize as V
from mj_envs_torch.utils import eval as E


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)    # six xdist workers share the CPU
    yield
    torch.set_num_threads(n)


SMALL_PLANET = dict(belief_size=16, state_size=8, hidden_size=16,
                    embedding_size=32, planning_horizon=3,
                    optimisation_iters=2, candidates=20, top_candidates=5)


def _checkpoint(tmp_path, kind):
    """A checkpoint of the port's trainer state for `kind` (ppo, cnn,
    planet): its path and the config keys that go with it."""
    from mj_envs_torch.algos import planet as PL, ppo as PPO
    from mj_envs_torch.envs.pixels import PixelObservationEnv
    from mj_envs_torch.utils import checkpoint as CKPT
    from mj_envs_torch.utils.config import PlanetConfig
    env = tenvs.make("hammer-v0", device="cpu")
    if kind == "ppo":
        state, extra = PPO.make_ppo(env, 4, device="cpu")[0](1), {}
    elif kind == "cnn":
        state = PPO.make_pixel_ppo(PixelObservationEnv(env), 4,
                                   device="cpu")[0](1)
        extra = {"model_type": "cnn"}
    else:
        cfg = PlanetConfig()
        cfg.__dict__.update(SMALL_PLANET)
        state = PL.make_planet(PL.cfg_from_config(cfg, env.nu),
                               device="cpu")[0](1)
        extra = dict(SMALL_PLANET)
    path = str(tmp_path / kind / f"{kind}_ckpt_00000001.pt")
    return CKPT.save(path, state), extra


@pytest.mark.parametrize("kind", ["dapg", "ppo", "cnn", "planet"])
def test_run_eval_policy_paths(tmp_path, kind):
    """Each policy path of run_eval on 10 envs x 2 steps: finite
    artifacts; the worst trajectory's gif holds its 2 frames."""
    write_mjrl_pickle(str(tmp_path / "hammer-v0.pickle"), seed=3)
    cfg = {"env_name": "hammer-v0", "seed": 0, "device_type": "cpu"}
    policy_type = {"dapg": "dapg", "cnn": "ppo"}.get(kind, kind)
    if kind != "dapg":
        cfg["models_path"], extra = _checkpoint(tmp_path, kind)
        cfg.update(extra)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    out, name = E.run_eval(str(tmp_path / "cfg.json"), policy_type,
                           episodes=1, out=str(tmp_path / "out"),
                           episode_length=2, dapg_root=str(tmp_path))
    files = sorted(os.listdir(out))
    assert files == sorted([f"{name}_0.gif", f"{name}_eval_rewards.png",
                            f"{name}_eval_success.png"])
    with Image.open(os.path.join(out, f"{name}_0.gif")) as im:
        assert im.n_frames == 2 and im.size == (128, 128)


@pytest.mark.parametrize("kind", ["pickle", "ppo", "planet"])
def test_visualize_policy_kinds(tmp_path, kind):
    """visualize's policy sniffing on real 2-step rollouts: a pickle is
    "dapg", a checkpoint "ppo", a path with "planet" PlaNet (its sizes
    from --config_path)."""
    args = ["--env_name", "hammer-v0", "--out", str(tmp_path / "vis"),
            "--device", "cpu", "--max_steps", "2", "--seed", "0"]
    if kind == "pickle":
        policy = write_mjrl_pickle(str(tmp_path / "hammer-v0.pickle"), 3)
        name = "dapg"
    else:
        policy, extra = _checkpoint(tmp_path, kind)
        name = kind
        if kind == "planet":
            (tmp_path / "p.json").write_text(json.dumps(extra))
            args += ["--config_path", str(tmp_path / "p.json")]
    V.main(args + ["--policy", policy])
    gif = tmp_path / "vis" / f"visualise_hammer-v0_{name}_0.gif"
    with Image.open(gif) as im:
        assert im.n_frames == 3 and im.size == (128, 128)
    assert (tmp_path / "vis" / "rewards_hammer-v0.png").exists()
