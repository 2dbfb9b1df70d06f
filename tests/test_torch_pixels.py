"""The port's pixel envs, quatmath and CNN actor-critic against the JAX
package, and its pixel-PPO trainer and evaluator on the CPU.

* Every quatmath function on seeded inputs: 1e-6 (abs) in float32,
  1e-12 in float64.
* The CNN forward with the JAX package's weights carried across
  (`cnn_actor_critic_from_numpy`), on float and on uint8 pixels: float64
  1e-12, float32 rtol 1e-4 / atol 1e-5 (conv sums of 512 terms).  The fc
  layer reads the conv output in the JAX package's HWC order; torch's
  own CHW order would give other numbers, and the test shows that it
  does.
* `PixelObservationEnv`: reset / step shapes, the state and pixel
  accessors, per-env pixels.
* `train_ppo_policy` with model_type "cnn" on door-v0 (2 envs) with a
  checkpoint round trip, `make_pixel_evaluate`, and run.py ppo on a cnn
  config asking for the CPU.
"""
import csv
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mj_envs_tpu.algos import networks as JN
from mj_envs_tpu.utils import quatmath as JQ
from mj_envs_torch import envs as tenvs
from mj_envs_torch import run as trun
from mj_envs_torch.algos import networks as TN
from mj_envs_torch.algos import ppo as TP
from mj_envs_torch.envs.pixels import PixelEnvState, PixelObservationEnv
from mj_envs_torch.utils import checkpoint as CKPT
from mj_envs_torch.utils import config as TC
from mj_envs_torch.utils import eval as TE
from mj_envs_torch.utils import quatmath as TQ
from mj_envs_torch.utils import train as TT

NP = {torch.float64: np.float64, torch.float32: np.float32}
QUAT_TOL = {torch.float64: 1e-12, torch.float32: 1e-6}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)    # six xdist workers share the CPU
    yield
    torch.set_num_threads(n)


class _CsvMetrics(TT.Metrics):
    """The trainers' metrics without their TensorBoard writer, whose
    import costs ~12 s a process (`tests/test_torch_train.py` runs the
    state trainer with it)."""

    def __init__(self, tb_dir=None):
        super().__init__(None)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setattr(TT, "Metrics", _CsvMetrics)


# -- quatmath ---------------------------------------------------------------

def quat_inputs(dtype, n=64, seed=0):
    rng = np.random.default_rng(seed)
    f = NP[dtype]
    q = rng.standard_normal((2, n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return dict(qa=q[0].astype(f), qb=q[1].astype(f),
                axis=(q[0, :, 1:] / np.linalg.norm(q[0, :, 1:], axis=-1,
                                                   keepdims=True)).astype(f),
                angle=rng.uniform(-3.0, 3.0, n).astype(f),
                euler=rng.uniform(-1.5, 1.5, (n, 3)).astype(f))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_quatmath_matches_jax(dtype):
    x = quat_inputs(dtype)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    mats = JQ.quat2mat(j["qa"])
    cases = {
        "mulQuat": (JQ.mulQuat(j["qa"], j["qb"]), TQ.mulQuat(t["qa"], t["qb"])),
        "negQuat": (JQ.negQuat(j["qa"]), TQ.negQuat(t["qa"])),
        "quat2Vel": (JQ.quat2Vel(j["qa"], 0.5), TQ.quat2Vel(t["qa"], 0.5)),
        "quatDiff2Vel": (JQ.quatDiff2Vel(j["qa"], j["qb"], 0.1),
                         TQ.quatDiff2Vel(t["qa"], t["qb"], 0.1)),
        "axis_angle2quat": (JQ.axis_angle2quat(j["axis"], j["angle"]),
                            TQ.axis_angle2quat(t["axis"], t["angle"])),
        "mat2quat": (JQ.mat2quat(mats),
                     TQ.mat2quat(torch.as_tensor(np.array(mats)))),
        "euler2mat": (JQ.euler2mat(j["euler"]), TQ.euler2mat(t["euler"])),
        "euler2quat": (JQ.euler2quat(j["euler"]), TQ.euler2quat(t["euler"])),
        "quat2euler": (JQ.quat2euler(j["qa"]), TQ.quat2euler(t["qa"])),
    }
    for name, (want, got) in cases.items():
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for w, g in zip(want, got):
            assert g.dtype == dtype, name
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=QUAT_TOL[dtype], err_msg=name)
    # mat2quat inverts quat2mat up to the sign that makes w >= 0
    back = TQ.mat2quat(TQ.quat2mat(t["qa"]))
    want = t["qa"] * torch.where(t["qa"][:, :1] < 0, -1.0, 1.0).to(dtype)
    np.testing.assert_allclose(back.numpy(), want.numpy(), rtol=0,
                               atol=10 * QUAT_TOL[dtype])


# -- the CNN actor-critic ---------------------------------------------------

ACT = 26


def cnn_pair(dtype, seed=0):
    p = JN.cnn_actor_critic_init(jax.random.PRNGKey(seed), ACT,
                                 dtype=jnp.dtype(NP[dtype]))
    rng = np.random.default_rng(seed + 1)
    p["log_std"] = jnp.asarray(0.2 * rng.standard_normal(ACT)
                               .astype(NP[dtype]))
    return p, TN.cnn_actor_critic_from_numpy(p, device="cpu", dtype=dtype)


CNN_TOL = {torch.float64: dict(rtol=1e-12, atol=1e-12),
           torch.float32: dict(rtol=1e-4, atol=1e-5)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_cnn_forward_matches_jax(dtype):
    p, mod = cnn_pair(dtype)
    rng = np.random.default_rng(2)
    pix = rng.uniform(0.0, 255.0, (3, 64, 64, 3)).astype(np.float32)
    u8 = np.round(pix).astype(np.uint8)
    for x in (pix, u8):
        want = JN.cnn_actor_critic_apply(p, jnp.asarray(x))
        with torch.no_grad():
            got = mod(torch.as_tensor(x))
        for w, g in zip(want, got):
            assert g.dtype == dtype
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       **CNN_TOL[dtype])
    # leading axes, and the round trip of the weights
    with torch.no_grad():
        lead = mod(torch.as_tensor(u8[None]))[0]
    assert lead.shape == (1, 3, ACT)
    back = TN.cnn_actor_critic_to_numpy(mod)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(p)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_cnn_fc_reads_the_jax_flatten_order():
    """The same weights with torch's CHW flatten in place of HWC give
    other features: the forward test above would catch the permute left
    out."""
    p, mod = cnn_pair(torch.float64)
    x = torch.as_tensor(np.random.default_rng(3).uniform(
        0.0, 255.0, (2, 64, 64, 3)))
    want = np.asarray(JN.cnn_torso_apply(p["torso"], jnp.asarray(x.numpy())))
    with torch.no_grad():
        got = mod.features(x)
        y = x.permute(0, 3, 1, 2) / 255.0
        for conv in mod.convs:
            y = torch.relu(conv(y))
        chw = torch.relu(mod.fc(y.reshape(2, -1)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    assert np.abs(chw.numpy() - want).max() > 1e-3


def test_cnn_init_shapes():
    mod = TN.CnnActorCritic(5, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    assert [tuple(c.weight.shape) for c in mod.convs] == [
        (32, 3, 8, 8), (64, 32, 4, 4), (64, 64, 3, 3)]
    assert tuple(mod.fc.weight.shape) == (512, 1024)
    mean, log_std, value = mod(torch.zeros(4, 64, 64, 3, dtype=torch.uint8))
    assert mean.shape == (4, 5) and value.shape == (4,)
    assert torch.equal(log_std, torch.zeros(5))


# -- the pixel env, the trainer, the evaluator ------------------------------

@pytest.fixture(scope="module")
def door_pixels():
    return PixelObservationEnv(tenvs.make("door-v0", device="cpu"))


def test_pixel_env_reset_and_step(door_pixels):
    penv = door_pixels
    env = penv.env
    gen = env.generator(0)
    ps = penv.reset(2, gen)
    assert isinstance(ps, PixelEnvState)
    assert ps.pixels.shape == (2, 64, 64, 3)
    assert ps.pixels.dtype == torch.float32
    assert penv.get_state(ps).shape == (2, env.OBS_DIM)
    assert penv.get_pixels(ps) is ps.pixels
    ps2 = penv.step(ps, torch.zeros(2, env.nu), gen)
    assert bool(torch.isfinite(ps2.pixels).all())
    # rendered in chunks of one env: the same frames
    assert torch.equal(penv._render(ps2.state, 1), ps2.pixels)


def small_config(**kw):
    c = TC.PPOConfig()
    c.env_name, c.device_type, c.model_type = "door-v0", "cpu", "cnn"
    c.num_envs, c.n_steps, c.n_minibatches, c.n_epochs = 2, 2, 2, 1
    c.max_episodes, c.checkpoint_interval = 2, 1
    c.test_interval = 1000
    for k, v in kw.items():
        setattr(c, k, v)
    return c


def test_pixel_ppo_trainer_and_checkpoint(door_pixels, tmp_path):
    env = door_pixels.env
    out = str(tmp_path)
    rows = []
    ts, _ = TT.train_ppo_policy(small_config(), env, out,
                                callback=lambda e, r: rows.append(r))
    assert isinstance(ts.module, TN.CnnActorCritic)
    for r in rows:
        for k in ("pg_loss", "v_loss", "mean_reward", "steps_per_s",
                  "rollout_ms", "physics_ms", "render_ms", "policy_ms",
                  "gae_ms", "update_ms"):
            assert np.isfinite(r[k]), k
        assert r["rollout_ms"] >= \
            r["physics_ms"] + r["render_ms"] + r["policy_ms"]
    with open(os.path.join(out, "metrics.csv")) as f:
        assert len(list(csv.DictReader(f))) == 2
    penv = PixelObservationEnv(env)
    init_fn = TP.make_pixel_ppo(penv, 2, TT.ppo_config(small_config()),
                                device="cpu")[0]
    back = CKPT.restore(CKPT.latest(out), init_fn(7))
    for a, b in zip(back.module.parameters(), ts.module.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(back.generator.get_state(), ts.generator.get_state())

    def policy(module, pixels, gen):
        return torch.clamp(module(pixels)[0], -1.0, 1.0)

    res = TE.make_pixel_evaluate(penv, policy, 3)(ts.module, 1, count=2)
    assert res.obs.shape == (2, 3, env.OBS_DIM)
    assert np.isfinite(res.total_rewards).all()


def test_run_pixel_ppo_on_the_cpu(tmp_path):
    c = small_config(max_episodes=1, n_steps=1, log_path=str(tmp_path / "r"))
    path = str(tmp_path / "door_cnn.json")
    c.save(path)
    trun.main(["run", path, "ppo"])
    assert {"ckpt_00000001.pt", "config.json", "metrics.csv"} <= set(
        os.listdir(tmp_path / "r"))
