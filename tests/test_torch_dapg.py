"""The port's DAPG policy loader (`mj_envs_torch/algos/dapg.py`) and
its DAPG update against the JAX package's, CPU.

The reference's pretrained pickles are not in the repository, so the
loader reads a synthetic one of the same shape (`chip_smoke.py`'s
`write_mjrl_pickle`: an mjrl MLP holding a 46 -> 32 -> 32 -> 26 tanh
FCNetwork with shifts and scales, the mjrl classes stand-ins registered
only while pickling).  Both packages' `load_dapg_params` must give the
same arrays, and their `make_policy` the same actions.  Then one door-v0
NPG iteration with 32 demo pairs (the DAPG term lam0 * lam1^k times the
demos' log-prob gradient) against the jitted JAX iteration, in float64,
as `tests/test_torch_npg.py` holds the plain NPG one.
"""
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import write_mjrl_pickle
from mj_envs_tpu.algos import dapg as JD
from mj_envs_tpu.algos import npg as JNPG
from mj_envs_torch.algos import dapg as TD
from mj_envs_torch.algos import npg as TNPG
from test_torch_npg import (TToyEnv, check_door, door_errors, max_err,
                            toy_states)

KEYS = ("log_std", "in_shift", "in_scale", "out_shift", "out_scale",
        "obs_dim", "act_dim", "nonlinearity")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)    # six xdist workers share the CPU
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pickle_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dapg")
    write_mjrl_pickle(str(root / "hammer-v0.pickle"), seed=3)
    return str(root)


def test_loader_matches_jax(pickle_root):
    path = os.path.join(pickle_root, "hammer-v0.pickle")
    got, want = TD.load_dapg_params(path), JD.load_dapg_params(path)
    assert set(got) == set(want)
    assert len(got["layers"]) == len(want["layers"]) == 3
    for (w, b), (wj, bj) in zip(got["layers"], want["layers"]):
        assert w.dtype == wj.dtype == np.float64
        np.testing.assert_array_equal(w, wj)
        np.testing.assert_array_equal(b, bj)
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["obs_dim"], got["act_dim"], got["nonlinearity"]) == (
        46, 26, "tanh")
    # No stand-in is left registered.
    import sys
    assert not any(n.split(".")[0] == "mjrl" for n in sys.modules)


@pytest.mark.parametrize("dtype,atol", [(torch.float64, 1e-14),
                                        (torch.float32, 2e-5)],
                         ids=["f64", "f32"])
def test_make_policy_matches_jax(pickle_root, dtype, atol):
    """64 obs of hammer's width: float64 worst 8.9e-16 (actions of scale
    ~3), float32 3.8e-6 (max abs)."""
    params = TD.load_dapg_params(os.path.join(pickle_root,
                                              "hammer-v0.pickle"))
    obs = np.random.default_rng(0).standard_normal((64, 46))
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    want = np.asarray(JD.make_policy(params, jnp.dtype(np_dt))(
        jnp.asarray(obs.astype(np_dt))))
    act, p = TD.load_policy("hammer", device="cpu", dtype=dtype,
                            root=pickle_root)
    got = act(torch.as_tensor(obs.astype(np_dt)))
    assert got.dtype == dtype and got.shape == (64, 26)
    assert max_err(got, want) <= atol
    assert float(np.abs(want).max()) > 1.0


def test_missing_pickle_raises_as_jax(tmp_path):
    """The default root is the JAX package's; an absent pickle raises
    FileNotFoundError in both."""
    jax_root = inspect.signature(JD.load_policy).parameters["root"].default
    assert TD.DEFAULT_ROOT == jax_root
    assert inspect.signature(TD.load_policy).parameters["root"].default \
        == jax_root
    for load in (JD.load_policy, TD.load_policy):
        with pytest.raises(FileNotFoundError):
            load("door", root=str(tmp_path))


def test_demo_weight_decays_as_jax():
    """lam0 * lam1^k in float32, as `npg.py:236-238` computes it, at
    iteration 5 of the port's loop (toy env, 4 demo pairs)."""
    cfg = TNPG.NPGConfig(n_steps=1, hidden=(4,))
    env = TToyEnv()
    demos = {"obs": np.zeros((4, env.OBS_DIM)),
             "actions": np.zeros((4, env.nu))}
    init_fn, it, _ = TNPG.make_npg(env, 2, cfg, demos=demos, device="cpu")
    st = init_fn(0)
    st.iteration = 5
    ex = {}
    st, _, _ = it(st, toy_states(0, 2, torch.float64)[1], extras=ex)
    want = JNPG.NPGConfig().lam0 * JNPG.NPGConfig().lam1 ** jnp.asarray(
        5, jnp.float32)
    assert ex["demo_weight"] == float(want)
    assert st.iteration == 6


def dapg_door_errors(seed=0):
    return door_errors(torch.float64, seed, demos=True)


# 2-4x the worst over seeds 0-2 (rewards and returns exact at all three).
DAPG_F64 = dict(advantages=2e-14, g=1e-13, direction=1e-12, quad=1.5e-12,
                params=6e-14, written_out=5e-14, kl=4e-15, step_size=1e-15,
                mean_reward=1e-15, mean_return=1e-15, grad_norm=1e-13,
                nan_resets=0.0, qpos=2e-16, qvel=5e-14)


def test_door_dapg_iteration_matches_jax_f64():
    """door-v0, 2 envs x 2 steps, hidden (8,), 32 demo pairs near the
    start states, float64.  Worst over seeds 0-2: advantages 4.4e-15, g
    3.0e-14, the direction 2.8e-13, quad 4.0e-13, params 2.0e-14, KL
    1.1e-15; bounds `DAPG_F64`."""
    check_door(dapg_door_errors(), DAPG_F64)
