"""The port's NPG / DAPG and SAC trainers, their checkpoints and
`run.py npg | sac | dapg` (`mj_envs_torch/utils/train.py`,
`utils/checkpoint.py`, `run.py`), CPU.

* `train_npg_policy` and `train_sac_policy` (`device_type` "cpu") on
  door-v0 (2 envs, 2 iterations, the episode cap lowered to 5 steps so
  that the evaluation is short): the rows and the metrics CSV, the evaluation,
  a checkpoint per iteration restored bit for bit, and the loop equal to
  its own steps taken by hand.
* The checkpoint's field types (tensors, ints, a dataclass of tensors
  and ints, modules, optimizers, generators) round-trip, a tensor in
  place; a PPO checkpoint of the earlier format still loads.
* The learner configs: the JAX package's NPGConfig and SACConfig
  fields and defaults; `configs/door_npg.json` trains NPG at n_steps 64,
  gamma 0.995, lambda 0.97, delta 0.1 and `configs/relocate_sac.json`
  SAC at batch 50 (a Config's batch_size), as the JAX trainers do.
* `run.py npg`, `sac` and `dapg` on the CPU; `dapg` without the
  reference's pickles raises FileNotFoundError, as the JAX package's.
* The card by default: without one the trainers raise.
"""
import csv
import dataclasses
import os

import numpy as np
import pytest
import torch

from chip_smoke import write_mjrl_pickle
from mj_envs_tpu.algos import npg as JNPG
from mj_envs_tpu.algos import sac as JSAC
from mj_envs_torch import envs as tenvs
from mj_envs_torch import run as trun
from mj_envs_torch.algos import dapg as TD
from mj_envs_torch.algos import npg as TNPG
from mj_envs_torch.algos import ppo as TP
from mj_envs_torch.algos import sac as TSAC
from mj_envs_torch.envs.door import DoorEnv
from mj_envs_torch.utils import checkpoint as CKPT
from mj_envs_torch.utils import config as TC
from mj_envs_torch.utils import train as TT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP = 5


@pytest.fixture(scope="module")
def door():
    n = torch.get_num_threads()
    torch.set_num_threads(1)    # six xdist workers share the CPU
    env = tenvs.make("door-v0", device="cpu")
    env.MAX_EPISODE_STEPS = CAP
    yield env
    torch.set_num_threads(n)


def small_config(**kw):
    c = TC.Config()
    c.env_name, c.device_type = "door-v0", "cpu"
    c.num_envs, c.max_episodes = 2, 2
    c.checkpoint_interval, c.test_interval = 1, 2
    for k, v in kw.items():
        setattr(c, k, v)
    return c


def equal_states(a, b, path=""):
    """Two train states equal bit for bit, field by field."""
    for f in dataclasses.fields(a):
        x, y, name = getattr(a, f.name), getattr(b, f.name), path + f.name
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state()), name
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), name
        elif isinstance(x, int):
            assert x == y, name
        elif dataclasses.is_dataclass(x):
            equal_states(x, y, name + ".")
        elif isinstance(x, torch.optim.Optimizer):
            sx, sy = x.state_dict(), y.state_dict()
            assert sx["param_groups"] == sy["param_groups"], name
            for i in sx["state"]:
                for k in sx["state"][i]:
                    assert torch.equal(torch.as_tensor(sx["state"][i][k]),
                                       torch.as_tensor(sy["state"][i][k])), \
                        (name, i, k)
        else:
            for (kx, vx), (ky, vy) in zip(x.state_dict().items(),
                                          y.state_dict().items()):
                assert kx == ky and torch.equal(vx, vy), (name, kx)


def check_run(out, rows, timing_keys, metric_keys):
    assert [r["episode"] for r in rows] == [1, 2]
    for r in rows:
        for k in ("steps_per_s",) + timing_keys + metric_keys:
            assert np.isfinite(r[k]), k
    with open(os.path.join(out, "metrics.csv")) as f:
        table = list(csv.DictReader(f))
    # Two iteration rows and the evaluation's at iteration 2.
    assert len(table) == 3 and table[2]["eval_reward"] != ""
    assert float(table[0]["mean_reward"]) == pytest.approx(
        rows[0]["mean_reward"])
    assert sorted(n for n in os.listdir(out) if n.startswith("ckpt_")) == \
        ["ckpt_00000001.pt", "ckpt_00000002.pt"]
    return CKPT.latest(out)


def test_train_npg_policy_on_the_cpu(door, tmp_path):
    out = str(tmp_path)
    c = small_config(n_steps=2)
    rows = []
    st, _ = TT.train_npg_policy(c, door, out,
                                callback=lambda e, r: rows.append(r))
    latest = check_run(out, rows, ("rollout_ms", "update_ms"),
                       ("mean_return", "step_size", "kl", "grad_norm",
                        "nan_resets", "quad"))
    assert st.iteration == 2
    cfg = TT.npg_config(c)
    init_fn, it, _ = TNPG.make_npg(door, 2, cfg, device="cpu")
    fresh = init_fn(c.seed + 7)
    assert not torch.equal(fresh.module.log_std, st.module.log_std)
    equal_states(CKPT.restore(latest, fresh), st)
    # The loop is its own steps by hand: init, reset, two iterations.
    hand = init_fn(c.seed)
    es = door.reset(2, hand.reset_generator)
    for _ in range(2):
        hand, es, _ = it(hand, es)
    equal_states(hand, st)


def test_train_dapg_policy_on_the_cpu(door, tmp_path):
    """With demos the trainer runs DAPG: the same loop, the demo term
    moving the params away from plain NPG's."""
    rng = np.random.default_rng(0)
    demos = {"obs": rng.standard_normal((16, door.OBS_DIM)),
             "actions": rng.uniform(-1, 1, (16, door.nu))}
    c = small_config(n_steps=2, max_episodes=1, test_interval=9)
    st, _ = TT.train_npg_policy(c, door, str(tmp_path / "d"), demos=demos)
    plain, _ = TT.train_npg_policy(c, door, str(tmp_path / "p"))
    assert st.iteration == plain.iteration == 1
    assert not torch.equal(st.module.actor[0].weight,
                           plain.module.actor[0].weight)


def test_train_sac_policy_on_the_cpu(door, tmp_path):
    """The Config's batch_size 50: iteration 1 (32 transitions) skips
    its updates, iteration 2 (64) runs 16."""
    out = str(tmp_path)
    c = small_config(learning_rate=3e-4)
    rows = []
    st, _ = TT.train_sac_policy(c, door, out,
                                callback=lambda e, r: rows.append(r))
    latest = check_run(out, rows, ("collect_ms", "update_ms"),
                       ("critic_loss", "actor_loss", "alpha", "replay_size",
                        "nan_resets"))
    assert rows[0]["critic_loss"] == 0.0 and rows[1]["critic_loss"] > 0.0
    assert [r["replay_size"] for r in rows] == [32.0, 64.0]
    assert (st.env_steps, st.replay.idx, st.replay.size) == (64, 64, 64)
    cfg = TT.sac_config(c)
    init_fn, it, _ = TSAC.make_sac(door, 2, cfg, device="cpu")
    fresh = init_fn(c.seed + 7)
    back = CKPT.restore(latest, fresh)
    assert back.log_alpha is fresh.opt_alpha.param_groups[0]["params"][0]
    equal_states(back, st)
    hand = init_fn(c.seed)
    es = door.reset(2, hand.reset_generator)
    for _ in range(2):
        hand, es, _ = it(hand, es)
    equal_states(hand, st)


@dataclasses.dataclass
class _Ring:
    data: torch.Tensor
    head: int


@dataclasses.dataclass
class _State:
    module: torch.nn.Linear
    opt: torch.optim.Optimizer
    scale: torch.nn.Parameter
    count: int
    ring: _Ring
    gen: torch.Generator


def _make_state(seed, dtype=torch.float64):
    torch.manual_seed(seed)
    lin = torch.nn.Linear(3, 2, dtype=dtype)
    scale = torch.nn.Parameter(torch.randn((), dtype=dtype))
    opt = torch.optim.Adam(list(lin.parameters()) + [scale], lr=0.1)
    return _State(lin, opt, scale, seed, _Ring(torch.randn(4, 3,
                                                           dtype=dtype),
                                               seed + 1),
                  torch.Generator().manual_seed(seed))


def test_checkpoint_field_types_round_trip(tmp_path):
    a = _make_state(1)
    loss = a.module(torch.ones(3, dtype=torch.float64)).sum() * a.scale
    loss.backward()
    a.opt.step()
    a.gen.manual_seed(5)
    path = CKPT.save(str(tmp_path / "c.pt"), a)
    b = _make_state(2)
    scale = b.scale
    CKPT.restore(path, b)
    equal_states(b, a)
    assert b.scale is scale                        # restored in place
    # On the target's dtype: a float32 target takes the saved float64.
    c = _make_state(3, torch.float32)
    CKPT.restore(path, c)
    assert c.ring.data.dtype == torch.float32
    torch.testing.assert_close(c.ring.data, a.ring.data.float())

    @dataclasses.dataclass
    class Bad:
        name: str
    with pytest.raises(TypeError, match="name"):
        CKPT.save(str(tmp_path / "bad.pt"), Bad("x"))


def test_ppo_checkpoint_of_the_earlier_format_loads(door, tmp_path):
    """A PPO TrainState's checkpoint as the port wrote it before this
    extension (the four fields' state dicts and generator states)
    restores, and `save` writes the same fields."""
    init_fn, _, _ = TP.make_ppo(door, 2, TP.PPOConfig(hidden=(8,)),
                                device="cpu")
    ts = init_fn(0)
    path = str(tmp_path / "old.pt")
    torch.save({"module": ts.module.state_dict(),
                "optimizer": ts.optimizer.state_dict(),
                "generator": ts.generator.get_state(),
                "reset_generator": ts.reset_generator.get_state()}, path)
    back = CKPT.restore(path, init_fn(9))
    equal_states(back, ts)
    new = torch.load(CKPT.save(str(tmp_path / "new.pt"), ts),
                     weights_only=True)
    assert set(new) == {"module", "optimizer", "generator",
                        "reset_generator"}


def test_learner_configs_match_jax():
    assert TNPG.NPGConfig()._asdict() == JNPG.NPGConfig()._asdict()
    assert TSAC.SACConfig()._asdict() == JSAC.SACConfig()._asdict()
    door = TC.load_config(os.path.join(ROOT, "configs", "door_npg.json"),
                          "npg")
    cfg = TT.npg_config(door)
    assert (cfg.n_steps, cfg.gamma, cfg.gae_lambda,
            cfg.normalized_step_size) == (64, 0.995, 0.97, 0.1)
    reloc = TC.load_config(os.path.join(ROOT, "configs",
                                        "relocate_sac.json"), "sac")
    cfg = TT.sac_config(reloc)
    assert (cfg.batch_size, cfg.lr) == (50, 3e-4)
    reloc.batch_size = 0
    assert TT.sac_config(reloc).batch_size == 256


def _config_file(tmp_path, **kw):
    c = small_config(max_episodes=1, log_path=str(tmp_path / "run"), **kw)
    path = str(tmp_path / "cfg.json")
    c.save(path)
    return path


@pytest.mark.parametrize("policy", ["npg", "sac"])
def test_run_learner_on_the_cpu(tmp_path, monkeypatch, policy):
    """`python -m mj_envs_torch.run <config> npg | sac` with a config
    asking for the CPU (the episode cap lowered for the test)."""
    monkeypatch.setattr(DoorEnv, "MAX_EPISODE_STEPS", CAP)
    trun.main(["run", _config_file(tmp_path, test_interval=1), policy])
    out = tmp_path / "run"
    assert {"ckpt_00000001.pt", "config.json", "metrics.csv"} <= set(
        os.listdir(out))
    with open(out / "metrics.csv") as f:
        assert len(list(csv.DictReader(f))) == 2      # iteration + eval


def test_run_dapg_on_the_cpu(tmp_path, monkeypatch, capsys):
    """`run.py dapg` evaluates the task's pickle; without the reference's
    pickles it raises FileNotFoundError, as the JAX package's run.py."""
    path = _config_file(tmp_path)
    with pytest.raises(FileNotFoundError):
        trun.main(["run", path, "dapg"])
    root = tmp_path / "pretrained"
    root.mkdir()
    write_mjrl_pickle(str(root / "door-v0.pickle"), seed=1,
                      sizes=(39, 32, 32, 28))
    monkeypatch.setattr(TD.load_policy, "__defaults__",
                        ("cuda", torch.float32, str(root)))
    monkeypatch.setattr(DoorEnv, "MAX_EPISODE_STEPS", CAP)
    capsys.readouterr()
    trun.main(["run", path, "default"])
    assert "dapg eval: reward" in capsys.readouterr().out


def test_trainers_default_to_the_card(door, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    c = small_config(device_type="cuda")
    for train in (TT.train_npg_policy, TT.train_sac_policy):
        with pytest.raises(RuntimeError, match="CUDA"):
            train(c, door, str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.make_policy(TD.load_dapg_params(write_mjrl_pickle(
            str(tmp_path / "p.pickle"), 0)))(torch.zeros(46))
