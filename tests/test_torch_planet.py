"""The port's PlaNet (`mj_envs_torch/algos/planet.py`) against the JAX
package's (`mj_envs_tpu/algos/planet.py`), CPU, at small widths (belief
16, state 4, hidden 16, embedding 32, action 3), on the JAX package's
weights (`planet_from_numpy`) and draws:

* the encoder, decoder, transition (its GRU) and posterior, reward
  model; the decoder's transposed convs with non-symmetric kernels, and
  a check that an unflipped kernel would give other images;
* the loss and its gradients on the JAX posterior noise, and one
  `update_fn` (clip to global norm 1000, Adam eps 1e-4) against optax;
* `infer_step` and `plan` on the JAX package's normals: in float64 the
  top-k members of every CEM iteration are the JAX package's and the
  planned action agrees to 9e-16; in float32 each iteration, started
  from the JAX package's mean and std, may swap at most
  `F32_SWAPS` members at the top-k boundary;
* `train_planet_policy` and run.py planet on a CPU config of a few
  steps, the checkpoint restored bit for bit, `load_planet_params` and
  `make_planet_evaluate`.

Tolerances are stated beside each test: max abs, 4x the worst over
seeds 0-2 where measured.
"""
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from mj_envs_tpu.algos import planet as JP
from mj_envs_torch import envs as tenvs
from mj_envs_torch import run as trun
from mj_envs_torch.algos import planet as TP
from mj_envs_torch.utils import checkpoint as CKPT
from mj_envs_torch.utils import config as TC
from mj_envs_torch.utils import eval as TE
from mj_envs_torch.utils import train as TT

NP = {torch.float64: np.float64, torch.float32: np.float32}
SMALL = dict(belief_size=16, state_size=4, hidden_size=16, embedding_size=32,
             action_size=3, candidates=40, top_candidates=8,
             planning_horizon=4, optimisation_iters=3)
T_SEQ, B_SEQ = 4, 3


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


_PARAMS = {}


def pair(dtype, seed=0):
    """(JAX cfg, JAX params, port module) on the same weights, the
    biases drawn nonzero so that they count; a fresh module each call,
    the JAX draws cached."""
    cfg_j = JP.PlanetConfig(**SMALL)
    if (dtype, seed) not in _PARAMS:
        _PARAMS[dtype, seed] = _jax_params(cfg_j, dtype, seed)
    p = _PARAMS[dtype, seed]
    return cfg_j, p, TP.planet_from_numpy(p, TP.PlanetConfig(**SMALL),
                                          device="cpu", dtype=dtype)


def _jax_params(cfg_j, dtype, seed):
    p = jax.jit(JP.init_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(seed), cfg_j, jnp.dtype(NP[dtype]))
    rng = np.random.default_rng(seed + 10)
    return jax.tree_util.tree_map(
        lambda x: x if x.ndim > 1 else jnp.asarray(
            0.1 * rng.standard_normal(x.shape).astype(x.dtype)), p)


def batch(seed, dtype, T=T_SEQ, B=B_SEQ):
    rng = np.random.default_rng(seed)
    f = NP[dtype]
    nt = (rng.uniform(size=(T, B)) > 0.2).astype(f)
    return dict(obs=rng.uniform(-0.5, 0.5, (T, B, 64, 64, 3)).astype(f),
                actions=rng.uniform(-1, 1, (T, B, 3)).astype(f),
                rewards=rng.standard_normal((T, B)).astype(f),
                nonterminals=nt)


def err(t, j):
    t = t.detach().double().numpy() if isinstance(t, torch.Tensor) else t
    return float(np.abs(np.asarray(t, np.float64)
                        - np.asarray(j, np.float64)).max())


def t_(x):
    return torch.as_tensor(np.array(x))


# -- the model's parts ------------------------------------------------------

def test_tree_round_trip():
    _, p, mod = pair(torch.float64)
    back = TP.planet_to_numpy(mod)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    flat_p, tree_p = jax.tree_util.tree_flatten(p)
    assert tree_b == tree_p
    for a, b in zip(flat_b, flat_p):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_parts_match_jax():
    """float64: encoder, decoder, transition step (GRU and prior),
    posterior, reward: worst 2.2e-16 over seeds 0-2, bound 9e-16."""
    cfg_j, p, mod = pair(torch.float64)
    b = batch(0, torch.float64)
    rng = np.random.default_rng(1)
    h = rng.standard_normal((B_SEQ, 16))
    s = rng.standard_normal((B_SEQ, 4))
    a = rng.uniform(-1, 1, (B_SEQ, 3))
    e = rng.standard_normal((B_SEQ, 32))
    with torch.no_grad():
        cases = {
            "encoder": (mod.encoder(t_(b["obs"])), JP.encoder(p, b["obs"])),
            "decoder": (mod.decoder(t_(h), t_(s)), JP.decoder(p, h, s)),
            "reward": (mod.reward_model(t_(h), t_(s)),
                       JP.reward_model(p, h, s)),
        }
        hn, (pm, ps) = mod.transition_step(t_(h), t_(s), t_(a))
        hj, (pmj, psj) = JP.transition_step(p, cfg_j, h, s, a)
        cases.update(gru=(hn, hj), prior_mean=(pm, pmj), prior_std=(ps, psj))
        qm, qs = mod.posterior_stats(t_(h), t_(e))
        qmj, qsj = JP.posterior_stats(p, cfg_j, h, e)
        cases.update(post_mean=(qm, qmj), post_std=(qs, qsj))
    assert cases["encoder"][0].shape == (T_SEQ, B_SEQ, 32)
    assert cases["decoder"][0].shape == (B_SEQ, 64, 64, 3)
    for name, (got, want) in cases.items():
        assert err(got, want) <= 9e-16, (name, err(got, want))


def test_decoder_kernels_cross_flipped():
    """`lax.conv_transpose(transpose_kernel=False)` does not flip its
    kernel; `conv_transpose2d` does.  On a non-symmetric random kernel
    the flipped crossing matches the JAX layer, the unflipped one does
    not."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((5, 5, 4, 2))          # HWIO, not symmetric
    x = rng.standard_normal((2, 3, 3, 4))          # NHWC
    want = np.asarray(jax.lax.conv_transpose(
        jnp.asarray(x), jnp.asarray(w), strides=(2, 2), padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    xt = t_(x).permute(0, 3, 1, 2)
    wt = t_(w).permute(2, 3, 0, 1)                 # (in, out, kH, kW)
    flipped = torch.nn.functional.conv_transpose2d(
        xt, wt.flip(2, 3), stride=2).permute(0, 2, 3, 1)
    plain = torch.nn.functional.conv_transpose2d(
        xt, wt, stride=2).permute(0, 2, 3, 1)
    assert want.shape == (2, 9, 9, 2)
    assert err(flipped, want) <= 1e-12
    assert err(plain, want) > 1e-2


# -- the loss, its gradients and one update ---------------------------------

def jax_posterior_noise(key, T, B, S, dtype):
    """The normals of `rollout_posterior`'s scan (`planet.py:196-199`)."""
    out, k = [], key
    for _ in range(T):
        k, ks = jax.random.split(k)
        out.append(np.asarray(jax.random.normal(ks, (B, S), dtype)))
    return np.stack(out)


def grads_np(mod):
    """The gradients of `mod` as the JAX package's tree."""
    g = TP.Planet(mod.cfg, device="cpu", dtype=mod.dtype)
    with torch.no_grad():
        for pg, p in zip(g.parameters(), mod.parameters()):
            pg.copy_(p.grad)
    return TP.planet_to_numpy(g)


def loss_errors(seed, dtype):
    cfg_j, p, mod = pair(dtype, seed)
    b = batch(seed, dtype)
    key = jax.random.PRNGKey(seed + 3)
    (loss_j, m_j), g_j = jax.jit(jax.value_and_grad(
        jax_loss_fn(cfg_j), has_aux=True))(
            p, key, *(jnp.asarray(b[k]) for k in ("obs", "actions", "rewards",
                                                  "nonterminals")))
    noise = jax_posterior_noise(key, T_SEQ - 1, B_SEQ, 4, NP[dtype])
    loss, m = TP.loss_fn(mod, *(t_(b[k]) for k in ("obs", "actions",
                                                    "rewards",
                                                    "nonterminals")),
                         noise=t_(noise))
    loss.backward()
    e = {k: err(m[k], m_j[k]) for k in m_j}
    e["loss"] = err(loss, loss_j)
    scale = max(float(np.abs(np.asarray(x)).max())
                for x in jax.tree_util.tree_leaves(g_j))
    e["grads"] = max(err(a, c) for a, c in zip(
        jax.tree_util.tree_leaves(grads_np(mod)),
        jax.tree_util.tree_leaves(g_j))) / scale
    return e


def jax_loss_fn(cfg_j):
    """`make_planet`'s `loss_fn`, a closure there, out of `update_fn`'s
    cells."""
    update_fn = JP.make_planet(cfg_j)[1]
    cells = dict(zip(update_fn.__code__.co_freevars, update_fn.__closure__))
    return cells["loss_fn"].cell_contents


def test_loss_and_gradients_match_jax():
    """float64: the losses worst 2.1e-12 (an obs loss ~1e4), bound
    8.2e-12; the gradients worst 1.0e-15 of their largest, bound 4.2e-15."""
    e = loss_errors(0, torch.float64)
    assert e["grads"] <= 4.2e-15, e
    assert max(v for k, v in e.items() if k != "grads") <= 8.2e-12, e


def update_errors(seed, dtype):
    """One JAX `update_fn` (clip_by_global_norm 1000, then adam eps 1e-4)
    against the port's on the same batch, weights and noise: the params'
    max abs difference, and how far the update moved them."""
    cfg_j, p, mod = pair(dtype, seed)
    b = batch(seed, dtype)
    init_j, update_j, _, _ = JP.make_planet(cfg_j)
    tx = optax.chain(optax.clip_by_global_norm(cfg_j.grad_clip_norm),
                     optax.adam(cfg_j.lr, eps=cfg_j.adam_eps))
    key = jax.random.PRNGKey(seed + 4)
    p_new, _, m_j = jax.jit(update_j)(p, tx.init(p), key,
                                      {k: jnp.asarray(v)
                                       for k, v in b.items()})
    cfg_t = TP.PlanetConfig(**SMALL)
    state = TP.PlanetState(mod, TP.make_optimizer(mod, cfg_t))
    update_t = TP.make_planet(cfg_t, device="cpu", dtype=dtype)[1]
    noise = jax_posterior_noise(key, T_SEQ - 1, B_SEQ, 4, NP[dtype])
    m = update_t(state, b, noise=t_(noise))
    got = jax.tree_util.tree_leaves(TP.planet_to_numpy(mod))
    want = jax.tree_util.tree_leaves(p_new)
    return dict(params=max(err(a, c) for a, c in zip(got, want)),
                moved=max(err(a, c) for a, c in zip(
                    want, jax.tree_util.tree_leaves(p))),
                metrics=max(err(m[k], m_j[k]) for k in m_j))


def test_update_matches_optax():
    """float64: params worst 3.7e-16, bound 1.5e-15 (the update moves
    them by lr = 1e-3: Adam's first step is lr * sign(g)); metrics worst
    1.1e-12, bound 4.6e-12.  (float32 is held card against CPU in
    `chip_smoke.py` phase 8c.)"""
    e = update_errors(0, torch.float64)
    assert e["moved"] > 5e-4, e
    assert e["params"] <= 1.5e-15 and e["metrics"] <= 4.6e-12, e


# -- acting: the filter and the planner -------------------------------------

def test_infer_step_matches_jax():
    """float64 on the JAX normal: worst 4.4e-16, bound 1.8e-15."""
    cfg_j, p, mod = pair(torch.float64)
    _, _, infer_j, _ = JP.make_planet(cfg_j)
    infer_t = TP.make_planet(TP.PlanetConfig(**SMALL), device="cpu",
                             dtype=torch.float64)[2]
    rng = np.random.default_rng(7)
    h, s = rng.standard_normal((2, 16)), rng.standard_normal((2, 4))
    a, obs = rng.uniform(-1, 1, (2, 3)), rng.uniform(-.5, .5, (2, 64, 64, 3))
    key = jax.random.PRNGKey(8)
    hj, sj = infer_j(p, key, h, s, a, obs)
    noise = np.asarray(jax.random.normal(key, (2, 4), jnp.float64))
    ht, st = infer_t(mod, t_(h), t_(s), t_(a), t_(obs), noise=t_(noise))
    assert err(ht, hj) <= 1.8e-15 and err(st, sj) <= 1.8e-15


def jax_cem(p, cfg_j, key, h, s, dtype):
    """`plan`'s scan written out with the JAX package's functions: per
    iteration its normals, its start (mean, std) and its top-k sets;
    and the planned action, which must be `plan`'s own."""
    A, Hz, C = cfg_j.action_size, cfg_j.planning_horizon, cfg_j.candidates
    Bt = h.shape[0]

    @jax.jit
    def cem_iter(mean, std, eps):
        acts = jnp.clip(mean[None] + std[None] * eps, -1.0, 1.0)

        def ret(a_seq):
            hh, ss, r = h, s, 0.0
            for t in range(Hz):
                hh, (pm, _) = JP.transition_step(p, cfg_j, hh, ss, a_seq[t])
                ss = pm
                r = r + JP.reward_model(p, hh, ss)
            return r

        _, top = jax.lax.top_k(jax.vmap(ret)(acts).T, cfg_j.top_candidates)
        best = jnp.take_along_axis(acts.transpose(2, 0, 1, 3),
                                   top[:, :, None, None], axis=1)
        return (best.mean(axis=1).transpose(1, 0, 2),
                best.std(axis=1).transpose(1, 0, 2) + 1e-6, top)

    mean = jnp.zeros((Hz, Bt, A), dtype)
    std = jnp.ones((Hz, Bt, A), dtype)
    k, its = key, []
    for _ in range(cfg_j.optimisation_iters):
        k, ks, _ = jax.random.split(k, 3)
        eps = jax.random.normal(ks, (C, Hz, Bt, A), dtype)
        m2, s2, top = cem_iter(mean, std, eps)
        its.append(dict(eps=np.asarray(eps), mean=np.asarray(mean),
                        std=np.asarray(std), top=np.asarray(top)))
        mean, std = m2, s2
    return its, np.asarray(mean[0])


def plan_pair(dtype, seed):
    cfg_j, p, mod = pair(dtype, seed)
    f = NP[dtype]
    rng = np.random.default_rng(seed + 20)
    h = rng.standard_normal((2, 16)).astype(f)
    s = rng.standard_normal((2, 4)).astype(f)
    key = jax.random.PRNGKey(seed + 21)
    its, action = jax_cem(p, cfg_j, key, jnp.asarray(h), jnp.asarray(s),
                          f)
    plan_j = JP.make_planet(cfg_j)[3]
    np.testing.assert_allclose(action, np.asarray(
        jax.jit(plan_j)(p, key, jnp.asarray(h), jnp.asarray(s))), rtol=0,
        atol=1e-12 if dtype == torch.float64 else 1e-6)
    return mod, t_(h), t_(s), its, action


def swaps(top_t, top_j):
    """Members of the top-k sets that differ, summed over the envs."""
    return sum(len(set(a.tolist()) - set(b.tolist()))
               for a, b in zip(top_t, top_j))


def test_plan_matches_jax_f64():
    """float64 on the JAX normals: every iteration's top-k sets are the
    JAX package's; the planned action worst 2.2e-16, bound 9e-16."""
    mod, h, s, its, action = plan_pair(torch.float64, 0)
    plan_t = TP.make_planet(TP.PlanetConfig(**SMALL), device="cpu",
                            dtype=torch.float64)[3]
    got = plan_t(mod, h, s, eps=t_(np.stack([i["eps"] for i in its])))
    assert err(got, action) <= 9e-16
    mean, std = t_(its[0]["mean"]), t_(its[0]["std"])
    for it in its:
        mean, std, top = TP.cem_step(mod, h, s, mean, std, t_(it["eps"]))
        assert swaps(top, it["top"]) == 0


# At most this many top-k members may differ per CEM iteration in float32
# (summed over the 2 envs, of 2 x 8), each iteration started from the JAX
# package's own mean and std.  None differed over seeds 0-2; one swap at
# the boundary is allowed, the least count that is not zero.
F32_SWAPS = 1


def f32_swaps(seed):
    """The most top-k members that differ in one float32 CEM iteration."""
    mod, h, s, its, _ = plan_pair(torch.float32, seed)
    return max(swaps(TP.cem_step(mod, h, s, t_(it["mean"]), t_(it["std"]),
                                 t_(it["eps"]))[2], it["top"]) for it in its)


def test_plan_f32_counts_boundary_swaps():
    assert f32_swaps(0) <= F32_SWAPS


# -- the trainer, run.py and the evaluator ----------------------------------

def planet_config(tmp, **kw):
    c = TC.PlanetConfig()
    c.env_name, c.device_type = "door-v0", "cpu"
    for k, v in dict(SMALL, seed_episodes=1, max_episodes=2,
                     max_episode_length=6, action_repeat=2, sample_iters=2,
                     batch_size=2, chunk_size=2, experience_size=64,
                     checkpoint_interval=1, log_path=str(tmp)).items():
        if k != "action_size":
            setattr(c, k, v)
    for k, v in kw.items():
        setattr(c, k, v)
    return c


@pytest.fixture(scope="module")
def door():
    return tenvs.make("door-v0", device="cpu")


def test_train_planet_checkpoint_and_evaluate(door, tmp_path):
    c = planet_config(tmp_path)
    rows = []
    state, _ = TT.train_planet_policy(c, door, str(tmp_path),
                                      callback=lambda e, r: rows.append(r))
    assert [r["episode"] for r in rows] == [2]
    for k in ("obs_loss", "rew_loss", "kl_loss", "reward", "update_ms",
              "sample_ms", "collect_ms", "plan_ms", "collect_steps_per_s"):
        assert np.isfinite(rows[0][k]), k
    latest = CKPT.latest(str(tmp_path))
    assert latest == CKPT.checkpoint_path(str(tmp_path), 2)
    cfg = TP.cfg_from_config(c, door.nu)
    fresh = TP.make_planet(cfg, device="cpu")[0](5)
    back = CKPT.restore(latest, fresh)
    assert CKPT._state_dict(back).keys() == {"params", "opt_state"}
    for a, b in zip(back.params.parameters(), state.params.parameters()):
        assert torch.equal(a, b)
    c.models_path = latest
    module = TE.load_planet_params(c, door)
    for a, b in zip(module.parameters(), state.params.parameters()):
        assert torch.equal(a, b)
    res = TE.make_planet_evaluate(door, c, 1)(module, 3, count=2)
    assert res.obs.shape == (2, 1, door.OBS_DIM)
    assert np.isfinite(res.total_rewards).all()


def test_run_planet_on_the_cpu(tmp_path):
    c = planet_config(tmp_path / "r", sample_iters=1)
    path = str(tmp_path / "door_planet.json")
    c.save(path)
    trun.main(["run", path, "planet"])
    assert {"ckpt_00000002.pt", "config.json", "metrics.csv"} <= set(
        os.listdir(tmp_path / "r"))
