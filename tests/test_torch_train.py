"""The port's trainer, evaluator, config, checkpoints and `run.py`
(`mj_envs_torch/utils/`, `mj_envs_torch/run.py`), CPU.

* `train_ppo_policy` (`device_type` "cpu") on door-v0 (2 envs, 2 iterations):
  the metrics CSV, a checkpoint per iteration, `restore` of the latest
  bit for bit, and a resumed run equal to its own steps taken by hand.
* `make_evaluate`: shapes, a plain fixed-length rollout (no auto-reset),
  and `_finish_eval` against the JAX package's on the same numpy inputs.
* `load_config` of the four committed configs: the JAX package's dict,
  `device_type` apart.
* The card by default: without one, and without "cpu" asked for, the
  learners raise.  Pixel PPO and PlaNet raise, naming their slice.
"""
import csv
import json
import os

import numpy as np
import pytest
import torch

from mj_envs_tpu.utils import config as JC
from mj_envs_tpu.utils import eval as JE
from mj_envs_torch import envs as tenvs
from mj_envs_torch import run as trun
from mj_envs_torch import trace
from mj_envs_torch.algos import ppo as TP
from mj_envs_torch.utils import checkpoint as CKPT
from mj_envs_torch.utils import config as TC
from mj_envs_torch.utils import eval as TE
from mj_envs_torch.utils import train as TT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"hammer_ppo.json": "ppo", "hammer_planet.json": "planet",
           "door_npg.json": "npg", "relocate_sac.json": "sac"}
NO_CARD = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="a card is present")


@pytest.fixture(scope="module")
def door():
    n = torch.get_num_threads()
    torch.set_num_threads(1)    # six xdist workers share the CPU
    yield tenvs.make("door-v0", device="cpu")
    torch.set_num_threads(n)


def small_config(**kw):
    c = TC.PPOConfig()
    c.env_name, c.device_type = "door-v0", "cpu"
    c.num_envs, c.n_steps, c.n_minibatches, c.n_epochs = 2, 2, 2, 2
    c.max_episodes, c.checkpoint_interval = 2, 1
    c.test_interval = 1000          # eval has its own test below
    for k, v in kw.items():
        setattr(c, k, v)
    return c


def state_equal(a: TP.TrainState, b: TP.TrainState):
    for (ka, va), (kb, vb) in zip(a.module.state_dict().items(),
                                  b.module.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i in sa["state"]:
        for k in sa["state"][i]:
            assert torch.equal(torch.as_tensor(sa["state"][i][k]),
                               torch.as_tensor(sb["state"][i][k])), (i, k)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert torch.equal(a.reset_generator.get_state(),
                       b.reset_generator.get_state())


def test_train_checkpoint_and_resume(door, tmp_path, capsys):
    out = str(tmp_path)
    c = small_config()
    rows = []
    ts, metrics = TT.train_ppo_policy(c, door, out,
                                      callback=lambda e, r: rows.append(r))
    assert [r["episode"] for r in rows] == [1, 2]
    for r in rows:
        for k in ("pg_loss", "v_loss", "entropy", "clip_fraction",
                  "approx_kl", "mean_reward", "mean_episode_done",
                  "nan_resets", "steps_per_s", "rollout_ms", "gae_ms",
                  "update_ms"):
            assert np.isfinite(r[k]), k
    with open(os.path.join(out, "metrics.csv")) as f:
        table = list(csv.DictReader(f))
    assert len(table) == 2 and float(table[1]["episode"]) == 2.0
    assert float(table[0]["mean_reward"]) == pytest.approx(
        rows[0]["mean_reward"])
    assert sorted(n for n in os.listdir(out) if n.startswith("ckpt_")) == \
        ["ckpt_00000001.pt", "ckpt_00000002.pt"]
    latest = CKPT.latest(out)
    assert latest == CKPT.checkpoint_path(out, 2)

    init_fn, train_iter_fn, _ = TP.make_ppo(door, 2, TT.ppo_config(c),
                                            device="cpu")
    fresh = init_fn(123)
    assert not torch.equal(fresh.module.actor[0].weight,
                           ts.module.actor[0].weight)
    state_equal(CKPT.restore(latest, fresh), ts)

    # Resume: the loop restores the latest checkpoint after its env
    # reset; the same steps by hand give the same params bit for bit.
    c2 = small_config(models_path="resume", max_episodes=1,
                      checkpoint_interval=100)
    capsys.readouterr()
    resumed, _ = TT.train_ppo_policy(c2, door, out)
    assert f"resumed from {latest}" in capsys.readouterr().out
    hand = init_fn(c2.seed)
    es = door.reset(2, hand.reset_generator)
    hand = CKPT.restore(latest, hand)
    hand, _, _ = train_iter_fn(hand, es)
    state_equal(resumed, hand)
    assert not torch.equal(resumed.module.actor[0].weight,
                           ts.module.actor[0].weight)


def test_profiler_hook_traces_episodes_2_to_3(door, tmp_path, monkeypatch):
    """The trace holds the tracer's spans as ranges (the tracer on over
    the profiled episodes only)."""
    monkeypatch.setenv("MJE_PROFILE_DIR", str(tmp_path / "prof"))
    TT.train_ppo_policy(small_config(max_episodes=3, checkpoint_interval=9),
                        door, str(tmp_path))
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    with open(tmp_path / "prof" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"env.step", "physics.substep", "physics.collide"} <= names
    assert not trace.enabled()


def test_evaluate_is_a_plain_fixed_length_rollout(door):
    """`count` fresh episodes of `episode_length` plain steps: equal to
    the same steps by hand, and not to an auto-reset rollout (the cap
    lowered to 2 steps on a copy of the env)."""
    def policy(module, obs, gen):
        return torch.tanh(obs[:, :door.nu])       # deterministic

    T, count = 4, 3
    res = TE.make_evaluate(door, policy, T)(None, seed=5, count=count)
    assert res.obs.shape == (count, T, door.OBS_DIM)
    assert res.qpos.shape == (count, T, door.nq)
    assert res.reward.shape == res.goal_achieved.shape == (count, T)
    assert res.total_rewards.shape == res.success_any.shape == (count,)
    np.testing.assert_allclose(res.total_rewards, res.reward.sum(1),
                               rtol=1e-6)
    assert res.success_rate == door.evaluate_success(res.goal_achieved)

    gen = door.generator(5)
    st = door.reset(count, gen)
    qpos = []
    for _ in range(T):
        st = door.step(st, policy(None, st.obs, gen))
        qpos.append(st.data.qpos.numpy())
    np.testing.assert_array_equal(res.qpos, np.stack(qpos, 1))

    capped = tenvs.make("door-v0", device="cpu")
    capped.MAX_EPISODE_STEPS = 2
    gen = capped.generator(5)
    st = capped.reset(count, gen)
    for _ in range(T):
        st = capped.step_auto_reset(st, policy(None, st.obs, gen), gen)
    assert not np.array_equal(res.qpos[:, -1], st.data.qpos.numpy())


def test_finish_eval_matches_jax(door):
    rng = np.random.default_rng(0)
    T, count = 40, 6
    obs = rng.standard_normal((T, count, 39)).astype(np.float32)
    rew = rng.standard_normal((T, count)).astype(np.float32)
    goal = rng.uniform(size=(T, count)) < 0.7
    done = rng.uniform(size=(T, count)) < 0.1
    qpos = rng.standard_normal((T, count, door.nq)).astype(np.float32)
    from mj_envs_tpu import envs as jenvs
    want = JE._finish_eval(jenvs.make("door-v0"), obs, rew, goal, done, qpos)
    got = TE._finish_eval(door, torch.as_tensor(obs), torch.as_tensor(rew),
                          torch.as_tensor(goal), torch.as_tensor(done),
                          torch.as_tensor(qpos))
    assert got._fields == want._fields
    for f in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    assert 0.0 < got.success_rate < 100.0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_load_config_matches_jax(name):
    path = os.path.join(ROOT, "configs", name)
    got = TC.load_config(path, CONFIGS[name]).__dict__
    want = JC.load_config(path, CONFIGS[name]).__dict__
    assert (got.pop("device_type"), want.pop("device_type")) == \
        ("cuda", "tpu")
    assert got == want


@NO_CARD
def test_learners_default_to_the_card(door):
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.make_ppo(door, 2, TP.PPOConfig())
    c = small_config()
    c.device_type = "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.train_ppo_policy(c, door, "unused")
    with pytest.raises(ValueError):                 # env and learner differ
        TP.make_ppo(door, 2, TP.PPOConfig(), device="meta")


def test_later_slices_raise(door, tmp_path):
    """Pixel PPO and PlaNet, the slices that came after this file's, run
    now (`tests/test_torch_pixel_ppo.py`, `tests/test_torch_planet.py`);
    like every learner they raise, with no fallback, where the config
    asks for the card and the env is not on one.  run.py lists every
    policy type of the JAX package's."""
    for train, kw in ((TT.train_ppo_policy, dict(model_type="cnn")),
                      (TT.train_planet_policy, {})):
        c = small_config(**kw)
        c.device_type = "cuda"
        with pytest.raises((RuntimeError, ValueError), match="CUDA|env is"):
            train(c, door, str(tmp_path))
    assert not hasattr(trun, "LATER")
    assert set(trun.POLICY_TYPES) == {"ppo", "npg", "sac", "dapg",
                                      "default", "planet"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            trun.main(["run", os.path.join(ROOT, "configs",
                                           "hammer_planet.json"), "planet"])


def test_debug_nans_raises_on_a_quarantined_env(door):
    cfg = TP.PPOConfig(n_steps=1, n_minibatches=1, n_epochs=1, hidden=(8,))
    init_fn, train_iter_fn, _ = TP.make_ppo(door, 2, cfg, device="cpu",
                                            debug_nans=True)
    ts = init_fn(0)
    es = door.reset(2, ts.reset_generator)
    qvel = es.data.qvel.clone()
    qvel[1, 0] = float("nan")
    es = es.replace(data=es.data.replace(qvel=qvel))
    with pytest.raises(FloatingPointError, match=r"envs \[1\]"):
        train_iter_fn(ts, es)


def test_run_ppo_on_the_cpu(tmp_path, monkeypatch):
    """`python -m mj_envs_torch.run <config> ppo` with a config asking for
    the CPU, under MJE_DEBUG_NANS=1."""
    c = small_config(max_episodes=1, log_path=str(tmp_path / "run"))
    path = str(tmp_path / "door_ppo.json")
    c.save(path)
    monkeypatch.setenv("MJE_DEBUG_NANS", "1")
    try:
        trun.main(["run", path, "ppo"])
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
    out = tmp_path / "run"
    assert {"ckpt_00000001.pt", "config.json", "metrics.csv"} <= set(
        os.listdir(out))
