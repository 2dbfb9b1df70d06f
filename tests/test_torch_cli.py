"""The port's CLIs (`mj_envs_torch/utils/eval.py` `run_eval` / `main`,
`mj_envs_torch/visualize.py`, `mj_envs_torch/viewer.py`) on the CPU.

`tests/test_cli.py`'s three tests on the port, with the same stubs and
the same artifact names; the DAPG policy comes from a synthetic mjrl
pickle (`chip_smoke.write_mjrl_pickle`) under an explicit root, so that
nothing reads the reference checkout:

* the eval protocol: episode ep evaluates with seed `seed + ep` (7 and
  8), one worst-trajectory gif per episode, the reward and success plots;
* the visualize CLI: no --policy is the pretrained DAPG policy, its
  gifs and the rewards plot;
* the headless viewer: the JAX test's key sequence and more (every key,
  the clamps), its camera state equal to the JAX viewer's after each
  key; its frame on the JAX viewer's state against the JAX frame.

Then what the stubs leave out: `render_state_trajectory` on 3 qpos at
64x64 against the JAX function, and every new entry point raising
without a card unless asked for the CPU (the policy paths on real
rollouts are in `test_torch_cli_paths.py`).  The pixel share is
`tests/test_torch_render.py`'s: at most 0.5 % of the pixels more than
1.0 apart.
"""
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import write_mjrl_pickle
from mj_envs_torch import envs as tenvs
from mj_envs_torch import visualize as V
from mj_envs_torch.utils import eval as E

PIXEL_SHARE = 0.005


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)    # six xdist workers share the CPU
    yield
    torch.set_num_threads(n)


def _share(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b).max(-1) > 1.0).mean())


def test_eval_cli_protocol(tmp_path, monkeypatch):
    seen_seeds = []

    def fake_make_evaluate(env, apply, episode_length):
        nq = env.model.qpos0.shape[0]

        def evaluate(params, seed, count=10):
            seen_seeds.append(seed)
            T = 4
            rng = np.random.default_rng(len(seen_seeds))
            rew = rng.normal(size=(count, T))
            goal = np.zeros((count, T), bool)
            return E.EvalResult(
                total_rewards=rew.sum(1), success_any=goal.any(1),
                success_rate=0.0, goal_achieved=goal,
                obs=np.zeros((count, T, 3), np.float32),
                qpos=np.zeros((count, T, nq), np.float32), reward=rew)

        return evaluate

    def fake_render(env, qpos_traj, height=128, width=128):
        return [np.zeros((8, 8, 3), np.uint8) for _ in range(len(qpos_traj))]

    monkeypatch.setattr(E, "make_evaluate", fake_make_evaluate)
    monkeypatch.setattr(V, "render_state_trajectory", fake_render)

    write_mjrl_pickle(str(tmp_path / "hammer-v0.pickle"), seed=3)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"env_name": "hammer-v0", "seed": 7,
                               "device_type": "cpu"}))
    out = tmp_path / "results"

    E.run_eval(str(cfg), policy_type="dapg", episodes=2, out=str(out),
               dapg_root=str(tmp_path))

    # The reference reseed protocol: episode ep uses seed + ep.
    assert seen_seeds == [7, 8]
    files = sorted(os.listdir(out))
    gifs = [f for f in files if f.endswith(".gif")]
    pngs = [f for f in files if f.endswith(".png")]
    assert len(gifs) == 2                    # one worst trajectory per ep
    assert any("eval_rewards" in f for f in pngs)
    assert any("eval_success" in f for f in pngs)


def test_visualize_cli_artifacts(tmp_path, monkeypatch):
    from mj_envs_torch.algos import dapg

    def fake_rollout(env, act_fn, seed, max_steps):
        frames = [np.zeros((8, 8, 3), np.uint8) for _ in range(3)]
        return frames, [0.5, -0.25]

    monkeypatch.setattr(V, "_rollout_frames", fake_rollout)
    write_mjrl_pickle(str(tmp_path / "hammer-v0.pickle"), seed=3)
    monkeypatch.setattr(dapg, "load_policy", functools.partial(
        dapg.load_policy, root=str(tmp_path)))

    out = tmp_path / "vis"
    V.main(["--env_name", "hammer-v0", "--episodes", "2", "--out", str(out),
            "--device", "cpu"])

    files = sorted(os.listdir(out))
    # Policy sniffing: no --policy -> the pretrained DAPG golden policy.
    assert "visualise_hammer-v0_dapg-golden_0.gif" in files
    assert "visualise_hammer-v0_dapg-golden_1.gif" in files
    assert "rewards_hammer-v0.png" in files


_CAM = ("azimuth", "elevation", "distance", "paused", "closed")
# the JAX test's keys, then every control to its clamps
KEYS = (["left", "+", " ", " "] + ["right"] * 3 + ["up"] * 15
        + ["down"] * 20 + ["+"] * 25 + ["-"] * 40 + ["=", "x"])


def test_interactive_viewer_headless_matches_jax():
    from mj_envs_tpu.viewer import InteractiveViewer as JViewer
    from mj_envs_torch.envs.base import _apply_var
    from mj_envs_torch.viewer import VIEWER_CAMS, InteractiveViewer

    jv = JViewer("hammer-v0", backend="Agg", height=64, width=80)
    v = InteractiveViewer("hammer-v0", backend="Agg", height=64, width=80,
                          device="cpu")
    # the reference mj_viewer_setup camera
    assert (v.azimuth, v.distance) == VIEWER_CAMS["hammer"]
    img = v.frame()
    assert img.shape == (64, 80, 3) and img.dtype == np.uint8
    for key in KEYS:
        jv.handle_key(key)
        v.handle_key(key)
        assert [getattr(v, a) for a in _CAM] == \
            [getattr(jv, a) for a in _CAM], key
    # elevation held at -89; distance held at 20, then one zoom in
    assert (v.elevation, v.distance) == (-89.0, 16.0)

    # The frame on the JAX viewer's state, its model fields and lookat.
    st_j = jv.state
    var = type(v.state.var)(**{
        f: torch.as_tensor(np.array(getattr(st_j.var, f)))[None]
        for f, _ in v.state.var.items()})
    v.state = v.env.set_physics_state(
        v.state.replace(var=var), np.array(st_j.data.qpos)[None],
        np.array(st_j.data.qvel)[None])
    v._model = _apply_var(v.env.model, var)
    v.lookat = np.asarray(jv.lookat)
    for key in ("left", "+"):
        jv.handle_key(key)
        v.handle_key(key)
    share = _share(v.frame(), jv.frame())
    assert share <= PIXEL_SHARE, share

    score = v.run(episodes=1, max_steps=3)
    assert np.isfinite(score)
    assert np.isfinite(v.frame()).all()
    v.handle_key("q")
    assert v.closed


def test_render_state_trajectory_matches_jax():
    from mj_envs_tpu import envs as jenvs
    from mj_envs_tpu import visualize as JV
    jenv = jenvs.make("hammer-v0")
    env = tenvs.make("hammer-v0", device="cpu")
    rng = np.random.default_rng(12)
    qpos = (np.asarray(jenv.model.qpos0)
            + 0.2 * rng.standard_normal((3, env.nq))).astype(np.float32)
    want = JV.render_state_trajectory(jenv, jnp.asarray(qpos), 64, 64)
    got = V.render_state_trajectory(env, qpos, 64, 64)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape == (64, 64, 3) and g.dtype == np.float32
        assert _share(g, w) <= PIXEL_SHARE, _share(g, w)
    assert float(np.std(got[0])) > 5.0


def test_entry_points_default_to_the_card(tmp_path):
    """Without a card every new entry point raises unless it is asked
    for the CPU; none carries on quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from mj_envs_torch import dryrun
    from mj_envs_torch import viewer as VW
    from mj_envs_torch.parallel import distributed as D
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"env_name": "hammer-v0"}))
    calls = [lambda: V.main(["--env_name", "hammer-v0", "--out",
                             str(tmp_path)]),
             lambda: VW.InteractiveViewer("hammer-v0", backend="Agg"),
             lambda: VW.main(["--env_name", "hammer-v0", "--backend",
                              "Agg"]),
             lambda: E.run_eval(str(cfg), "dapg", out=str(tmp_path)),
             lambda: dryrun.entry(),
             lambda: dryrun.main([]),
             lambda: D.initialize("tcp://127.0.0.1:1", 1, 0)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
