"""The port's SAC (`mj_envs_torch/algos/sac.py`) against the JAX
package's (`mj_envs_tpu/algos/sac.py`), CPU.

The pieces (`_sample_tanh`, `_q_apply`) on seeded inputs; the replay
ring's wrap; then whole iterations on the JAX package's draws (the
policy normals and warm-up uniforms of each collect step, each update's
replay indices and normals, split from the state's key as
`train_iter_fn` splits them; its first split, `kr`, is never used).  On
the toy env of `tests/test_torch_npg.py` (episodes truncate and
terminate inside the collection): one iteration of a single update, the
three Adam states and the polyak target included, then two iterations,
in the warm-up and past it.  On door-v0 (2 envs x 2 steps, hidden (16,),
buffer 64, batch 6, warm-up 4 env steps): the first iteration in the
warm-up with too few transitions for a batch (the updates skipped), the
second past both, against the jitted JAX iteration in float64 and
float32.

Under the tests' x64 the JAX package's replay and log_alpha would be
float64 whatever the params' dtype (`sac.py:106-114`): the JAX state is
built in the compared dtype, like with like.

Tolerances (max abs), 2-4x the worst over seeds 0-2 (`python
tests/measure_torch_learner_floors.py sac`), stated beside each test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mj_envs_tpu import envs as jenvs
from mj_envs_tpu.algos import networks as JN
from mj_envs_tpu.algos import sac as JSAC
from mj_envs_torch import envs as tenvs
from mj_envs_torch.algos import networks as TN
from mj_envs_torch.algos import sac as TSAC
from test_torch_npg import JToyEnv, TToyEnv, toy_states
from test_torch_ppo import max_err, to_port

NP = {torch.float64: np.float64, torch.float32: np.float32}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)    # six xdist workers share the CPU
    yield
    torch.set_num_threads(n)


def tree_err(a, b):
    return max(max_err(x, y) for x, y in zip(jax.tree_util.tree_leaves(a),
                                             jax.tree_util.tree_leaves(b)))


# -- pieces ---------------------------------------------------------------

def piece_errors(seed, dtype):
    """`_sample_tanh` on 64 x 6 means and log-stds (some saturating the
    tanh, where the 1e-6 clip acts) and `_q_apply` of a (8,)-hidden twin
    critic on 64 (obs, act) pairs."""
    f = NP[dtype]
    rng = np.random.default_rng(seed)
    mean = (3.0 * rng.standard_normal((64, 6))).astype(f)
    ls = rng.uniform(-3, 1, (64, 6)).astype(f)
    key = jax.random.PRNGKey(seed)
    a_j, lp_j = JSAC._sample_tanh(key, jnp.asarray(mean), jnp.asarray(ls))
    noise = np.asarray(jax.random.normal(key, mean.shape, mean.dtype))
    a_t, lp_t = TSAC._sample_tanh(torch.as_tensor(mean), torch.as_tensor(ls),
                                  torch.as_tensor(noise))
    crit = {q: jax.tree_util.tree_map(
        lambda x: x.astype(f), JN.mlp_init(jax.random.PRNGKey(seed + i),
                                           (10, 8, 1), 1.0))
        for i, q in enumerate(("q1", "q2"))}
    for q in crit:                         # non-zero biases
        crit[q][0]["b"] = jnp.asarray(rng.standard_normal(8).astype(f))
    obs = rng.standard_normal((64, 7)).astype(f)
    act = rng.uniform(-1, 1, (64, 3)).astype(f)
    q_j = JSAC._q_apply(crit, jnp.asarray(obs), jnp.asarray(act))
    tcrit = torch.nn.ModuleDict({q: TN.mlp_from_numpy(crit[q], "cpu", dtype)
                                 for q in crit})
    q_t = TSAC._q_apply(tcrit, torch.as_tensor(obs), torch.as_tensor(act))
    return dict(action=max_err(a_t, a_j), logp=max_err(lp_t, lp_j),
                q=max(max_err(x, y) for x, y in zip(q_t, q_j)),
                clipped=int((np.abs(np.asarray(a_j)) > 0.9999995).sum()))


@pytest.mark.parametrize("dtype,bound", [
    (torch.float64, dict(action=1.5e-15, logp=1e-9, q=3e-15)),
    (torch.float32, dict(action=1.5e-6, logp=1.0, q=1.5e-6))],
    ids=["f64", "f32"])
def test_sample_tanh_and_q_match_jax(dtype, bound):
    """Worst over seeds 0-2, float64: action 4.4e-16, q 8.9e-16,
    log-prob 2.5e-10; float32: action 4.8e-7, q 4.8e-7, log-prob 0.34 of
    values up to ~80.  The log-prob's floor is the JAX package's formula:
    where 1 - a^2 lies between its 1e-6 clip and ~1e-4, one ulp of tanh
    (the two libraries' tanh differ by one) moves log(1 - a^2) by up to
    ulp / (1 - a^2): 2e-10 in float64, 6 % in float32."""
    e = piece_errors(0, dtype)
    assert e["clipped"] > 0, e
    for k, b in bound.items():
        assert e[k] <= b, e


def test_replay_ring_wraps():
    """The JAX package's `test_sac_replay_ring_wraps` (slow there: it
    builds the ring by hand), on the port's ring: head 6 of 8, four
    stored, the head wraps to 2 and the size caps at 8."""
    cap, od, ad, B = 8, 3, 2, 4
    rep = TSAC.Replay.empty(cap, od, ad, "cpu", torch.float32)
    rep.idx = rep.size = 6
    rep.store(torch.arange(B * od, dtype=torch.float32).reshape(B, od),
              torch.ones(B, ad), torch.arange(B, dtype=torch.float32),
              torch.zeros(B, od), torch.tensor([True, False, True, False]))
    assert (rep.idx, rep.size) == (2, 8)
    np.testing.assert_array_equal(rep.reward.numpy()[[6, 7, 0, 1]],
                                  [0, 1, 2, 3])
    np.testing.assert_array_equal(rep.obs.numpy()[[6, 7, 0, 1]],
                                  np.arange(B * od).reshape(B, od))
    np.testing.assert_array_equal(rep.done.numpy()[[6, 7, 0, 1]],
                                  [True, False, True, False])
    assert not rep.done.numpy()[2:6].any()
    rep.store(torch.ones(3, od), torch.ones(3, ad), torch.full((3,), 9.0),
              torch.ones(3, od), torch.zeros(3, dtype=torch.bool))
    assert (rep.idx, rep.size) == (5, 8)
    np.testing.assert_array_equal(rep.reward.numpy()[2:5], [9, 9, 9])


# -- whole iterations -----------------------------------------------------

def jax_state(jenv, B, cfg, seed, dtype, log_alpha=-0.3):
    """The JAX package's initial SACState in `dtype` throughout (params,
    replay, log_alpha; the Adam states follow)."""
    f = NP[dtype]
    init_fn, _, _ = JSAC.make_sac(jenv, B, cfg)
    s = init_fn(jax.random.PRNGKey(seed))
    cast = lambda t: jax.tree_util.tree_map(lambda x: x.astype(f), t)
    actor, critic = cast(s.actor), cast(s.critic)
    la = jnp.asarray(log_alpha, f)
    cap, od, ad = cfg.buffer_size, jenv.OBS_DIM, jenv.nu
    tx = optax.adam(cfg.lr)
    replay = JSAC.Replay(
        obs=jnp.zeros((cap, od), f), action=jnp.zeros((cap, ad), f),
        reward=jnp.zeros((cap,), f), next_obs=jnp.zeros((cap, od), f),
        done=jnp.zeros((cap,), bool), idx=jnp.zeros((), jnp.int32),
        size=jnp.zeros((), jnp.int32))
    return JSAC.SACState(
        actor=actor, critic=critic, target_critic=critic, log_alpha=la,
        opt_actor=tx.init(actor), opt_critic=tx.init(critic),
        opt_alpha=tx.init(la), replay=replay,
        env_steps=jnp.zeros((), jnp.int32), key=jax.random.PRNGKey(seed + 3))


def port_state(tenv, B, cfg, js, dtype):
    init_fn, _, _ = TSAC.make_sac(tenv, B, TSAC.SACConfig(**cfg._asdict()),
                                  device="cpu")
    st = init_fn(0)
    return TSAC.sac_params_from_numpy(st, dict(
        actor=js.actor, critic=js.critic, log_alpha=js.log_alpha))


def jax_draws(state, cfg, B, nu, dtype):
    """Every draw of one JAX `train_iter_fn` from `state` (`sac.py:
    205-258`): per collect step the policy normals (key `ka`) and warm-up
    uniforms (`kw`), per update the replay indices (`ks`) below the size
    after the collection, the next-action normals (`kn`) and the actor
    normals (`ka`)."""
    f = NP[dtype]
    key, _ = jax.random.split(state.key)       # kr: never used
    pol, uni = [], []
    for _ in range(cfg.steps_per_iter):
        key, ka, kw = jax.random.split(key, 3)
        pol.append(np.asarray(jax.random.normal(ka, (B, nu), f)))
        uni.append(np.asarray(jax.random.uniform(kw, (B, nu), minval=-1.0,
                                                 maxval=1.0)))
    keys = jax.random.split(key, cfg.updates_per_iter + 1)
    size = min(int(state.replay.size) + B * cfg.steps_per_iter,
               cfg.buffer_size)
    sel, nxt, act = [], [], []
    for k in keys[1:]:
        ks, ka, kn = jax.random.split(k, 3)
        sel.append(np.asarray(jax.random.randint(
            ks, (cfg.batch_size,), 0, max(size, 1))))
        nxt.append(np.asarray(jax.random.normal(kn, (cfg.batch_size, nu), f)))
        act.append(np.asarray(jax.random.normal(ka, (cfg.batch_size, nu), f)))
    return {k: torch.as_tensor(np.stack(v)) for k, v in dict(
        policy=pol, uniform=uni, sel=sel, next=nxt, actor=act).items()}


def adam_tree(opt, modules):
    """The port's Adam moments in the JAX tree's layout: (mu, nu) of a
    layer list or a {"q1", "q2"} dict of them."""
    def layer_moments(layers, key):
        out = []
        for lyr in layers:
            w, b = opt.state[lyr.weight][key], opt.state[lyr.bias][key]
            out.append({"b": b.numpy(), "w": w.numpy().T})
        return out
    if isinstance(modules, torch.nn.ModuleDict):
        return tuple({q: layer_moments(modules[q], k) for q in modules}
                     for k in ("exp_avg", "exp_avg_sq"))
    return tuple(layer_moments(modules, k) for k in ("exp_avg", "exp_avg_sq"))


def state_errors(st, js):
    """Params, target critic, log_alpha and the three Adam states."""
    e = dict(actor=tree_err(TN.mlp_to_numpy(st.actor), js.actor),
             critic=tree_err(TSAC.sac_params_to_numpy(st)["critic"],
                             js.critic),
             target=tree_err(TSAC.sac_params_to_numpy(st)["target_critic"],
                             js.target_critic),
             log_alpha=max_err(st.log_alpha, js.log_alpha))
    for name, opt, mods, jopt in (
            ("adam_actor", st.opt_actor, st.actor, js.opt_actor),
            ("adam_critic", st.opt_critic, st.critic, js.opt_critic)):
        if not opt.state:                   # no step yet: JAX's are 0
            e[name] = max(float(np.abs(np.asarray(x)).max()) for x in
                          jax.tree_util.tree_leaves((jopt[0].mu,
                                                     jopt[0].nu)))
            continue
        mu, nu = adam_tree(opt, mods)
        e[name] = max(tree_err(mu, jopt[0].mu), tree_err(nu, jopt[0].nu))
        e[name + "_count"] = max_err(
            next(iter(opt.state.values()))["step"], jopt[0].count)
    if st.opt_alpha.state:
        a = st.opt_alpha.state[st.log_alpha]
        e["adam_alpha"] = max(max_err(a["exp_avg"], js.opt_alpha[0].mu),
                              max_err(a["exp_avg_sq"], js.opt_alpha[0].nu))
    return e


def replay_errors(rp, jrp, n):
    e = {f"replay_{f}": max_err(getattr(rp, f)[:n], getattr(jrp, f)[:n])
         for f in ("obs", "action", "reward", "next_obs")}
    e["replay_done"] = float(not np.array_equal(
        rp.done[:n].numpy(), np.asarray(jrp.done)[:n]))
    e["replay_head"] = float((rp.idx, rp.size) != (int(jrp.idx),
                                                    int(jrp.size)))
    return e


def run_iterations(jenv, tenv, B, cfg, seed, dtype, es_j, es_t, n_iter,
                   extra=None):
    """`n_iter` iterations in both packages from the same state and
    weights, the port on the JAX package's draws.  Per iteration, taken
    right after it (the port's state changes in place): the errors of
    `iteration_errors`, those of `extra(port env state, JAX env state)`,
    the port's metrics and ring, and both env states."""
    js = jax_state(jenv, B, cfg, seed, dtype)
    st = port_state(tenv, B, cfg, js, dtype)
    _, it_j, _ = JSAC.make_sac(jenv, B, cfg)
    _, it_t, _ = TSAC.make_sac(tenv, B, TSAC.SACConfig(**cfg._asdict()),
                               device="cpu")
    it_j = jax.jit(it_j)
    out = []
    for _ in range(n_iter):
        draws = jax_draws(js, cfg, B, jenv.nu, dtype)
        js, es_j, jm = it_j(js, es_j)
        st, es_t, tm = it_t(st, es_t, draws=draws)
        e = iteration_errors(st, js, tm, jm, es_t, es_j)
        if extra is not None:
            e.update(extra(es_t, es_j))
        n = st.replay.size
        out.append(dict(
            errors=e, tm={k: float(v) for k, v in tm.items()},
            size=n, es_t=es_t, es_j=es_j,
            replay_t={f: getattr(st.replay, f)[:n].clone() for f in
                      ("obs", "action", "reward", "next_obs", "done")},
            replay_j={f: np.asarray(getattr(js.replay, f))[:n] for f in
                      ("obs", "action", "reward", "next_obs", "done")}))
    return out


def iteration_errors(st, js, tm, jm, es_t, es_j):
    e = state_errors(st, js)
    e.update(replay_errors(st.replay, js.replay, st.replay.size))
    for k in jm:
        e[f"m_{k}"] = max_err(tm[k], jm[k])
    e["obs_after"] = max_err(es_t.obs, es_j.obs)
    e["env_steps"] = float(st.env_steps != int(js.env_steps))
    return e


TOY_CFG = dict(hidden=(8,), buffer_size=32, batch_size=8, steps_per_iter=4,
               updates_per_iter=2, warmup_steps=24)


def toy_runs(seed, n_iter=2, **kw):
    cfg = JSAC.SACConfig(**{**TOY_CFG, **kw})
    es_j, es_t = toy_states(seed, 6, torch.float64)
    return run_iterations(JToyEnv(), TToyEnv(), 6, cfg, seed,
                          torch.float64, es_j, es_t, n_iter)


def update_once_errors(seed):
    """One iteration of 4 collect steps and a single update."""
    return toy_runs(seed, 1, updates_per_iter=1)[0]["errors"]


# float64 toy bounds, 2-4x the worst over seeds 0-2 of one update and of
# two iterations (all at float64 rounding: params 1.1e-16, the polyak
# target 4.4e-16, the Adam moments 7.8e-16, the critic loss 3.6e-15).
TOY_BOUND = dict(actor=4e-16, critic=4e-16, target=1.5e-15, log_alpha=1e-16,
                 adam_actor=8e-16, adam_critic=3e-15, adam_alpha=8e-16,
                 adam_actor_count=0.0, adam_critic_count=0.0,
                 replay_obs=1e-15, replay_action=8e-16, replay_reward=1.5e-15,
                 replay_next_obs=3e-15, replay_done=0.0, replay_head=0.0,
                 m_critic_loss=1.2e-14, m_actor_loss=1.5e-15, m_alpha=4e-16,
                 m_mean_reward=2e-16, m_replay_size=0.0, m_nan_resets=0.0,
                 obs_after=1e-15, env_steps=0.0)


def check(e, bounds):
    over = {k: (v, bounds[k]) for k, v in e.items()
            if k in bounds and not v <= bounds[k]}
    missing = set(e) - set(bounds)
    assert not over and not missing, (e, missing)


def test_update_once_matches_jax():
    """One update on a batch of 8 of the 24 transitions the collection
    stored (toy env, float64): the actor, critic, polyak target,
    log_alpha, all three Adam states, the ring and the metrics at
    `TOY_BOUND`."""
    e = update_once_errors(0)
    check(e, TOY_BOUND)


def test_toy_iterations_in_and_past_the_warm_up():
    """Two iterations of 4 steps x 6 toy envs and 2 updates each: the
    first all warm-up (uniform actions), the second past it (policy
    actions, env_steps 24 >= 24); the ring holds truncation's final obs
    as next_obs with done 0, and a termination's done 1."""
    runs = toy_runs(0)
    for r in runs:
        check(r["errors"], TOY_BOUND)
    rp = runs[0]["replay_t"]
    assert rp["done"].any()
    # The first iteration's actions are the warm-up uniforms.
    assert float(rp["action"].abs().max()) > 0.9


# door-v0: the first iteration in the warm-up and below a batch, the
# second past both.
DOOR_CFG = dict(hidden=(16,), buffer_size=64, batch_size=6,
                steps_per_iter=2, updates_per_iter=2, warmup_steps=4)
_DOOR = {}


def door_runs(dtype, seed=0):
    """The two door-v0 iterations; float32 runs the JAX package with x64
    off, as it runs on its device (under x64 its skip branch's float64
    zeros would not match a float32 state's losses)."""
    if (dtype, seed) in _DOOR:
        return _DOOR[dtype, seed]
    with jax.enable_x64(dtype == torch.float64):
        f = jnp.dtype(NP[dtype])
        jenv = jenvs.make("door-v0", dtype=f)
        tenv = tenvs.make("door-v0", device="cpu", dtype=dtype)
        es_j = jax.jit(jax.vmap(jenv.reset))(
            jax.random.split(jax.random.PRNGKey(seed + 1), 2))
        _DOOR[dtype, seed] = run_iterations(
            jenv, tenv, 2, JSAC.SACConfig(**DOOR_CFG), seed, dtype, es_j,
            to_port(es_j, dtype), 2, extra=lambda t, j: dict(
                qpos=max_err(t.data.qpos, j.data.qpos),
                qvel=max_err(t.data.qvel, j.data.qvel)))
    return _DOOR[dtype, seed]


def door_errors(dtype, seed=0):
    return {f"{k}_{i + 1}": v for i, r in enumerate(door_runs(dtype, seed))
            for k, v in r["errors"].items()}


# 2-4x the worst over seeds 0-2 of either iteration; seed 2 sets most:
# door's stiff contact steps (qvel 1.7e-8 after one iteration's two
# steps, as `tests/test_torch_ppo.py` found at seed 1), carried into the
# ring and the critic's Adam moments; seeds 0 and 1 stay under 6e-14.
DOOR_F64 = dict(TOY_BOUND, actor=8e-13, critic=3e-13, adam_actor=2e-12,
                adam_critic=1e-10, adam_alpha=1e-14, replay_obs=2e-10,
                replay_action=1.5e-13, replay_reward=2e-12,
                replay_next_obs=3e-10, m_actor_loss=1e-12,
                m_critic_loss=2e-10, m_mean_reward=3e-13, obs_after=3e-10,
                qpos=3e-10, qvel=5e-8)


def test_door_iterations_match_jax_f64():
    """door-v0, float64: iteration 1 skips its updates (4 transitions <
    batch 6; critic and actor loss 0 in both, the params untouched),
    iteration 2 runs two; the bounds `DOOR_F64` for each (worst over
    seeds 0-2: qvel 1.7e-8, the ring 9.2e-11, the critic's Adam moments
    2.7e-11, the params 2.3e-13)."""
    runs = door_runs(torch.float64)
    assert runs[0]["tm"]["critic_loss"] == runs[0]["tm"]["actor_loss"] == 0
    assert runs[1]["tm"]["critic_loss"] > 0.0
    assert (runs[0]["size"], runs[1]["size"]) == (4, 8)
    e = door_errors(torch.float64)
    for i in (1, 2):
        check({k[:-2]: v for k, v in e.items() if k.endswith(f"_{i}")},
              DOOR_F64)


def test_door_iterations_match_jax_f32():
    """The same two iterations in float32: the env state and the ring's
    contents at `tests/test_torch_door.py`'s step bounds (rtol 1e-3 /
    atol 2e-3), the params within 2 lr per Adam step (worst over seeds
    0-2 2.1e-5, the critic)."""
    runs = door_runs(torch.float32)
    for r in runs:
        for f in ("qpos", "qvel"):
            np.testing.assert_allclose(
                getattr(r["es_t"].data, f).numpy(),
                np.asarray(getattr(r["es_j"].data, f)), rtol=1e-3, atol=2e-3,
                err_msg=f)
        for f in ("obs", "action", "reward", "next_obs"):
            np.testing.assert_allclose(r["replay_t"][f].numpy(),
                                       r["replay_j"][f], rtol=1e-3,
                                       atol=2e-3, err_msg=f)
        np.testing.assert_array_equal(r["replay_t"]["done"].numpy(),
                                      r["replay_j"]["done"])
    e = runs[1]["errors"]
    bound = 2 * DOOR_CFG["updates_per_iter"] * JSAC.SACConfig().lr
    assert max(e["actor"], e["critic"], e["target"]) <= bound, e


def test_make_sac_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        TSAC.make_sac(TToyEnv(), 2)
