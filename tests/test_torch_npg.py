"""The port's NPG (`mj_envs_torch/algos/npg.py`) against the JAX
package's (`mj_envs_tpu/algos/npg.py`), CPU.

Pieces first, in float64 on seeded numpy data: the baseline features
and ridge fit, the Fisher-vector product against the dense Fisher of
`tests/test_learners.py` and 10 CG steps against the JAX package's CG.
Then whole iterations on the JAX package's action normals (drawn as
`train_iter_fn` draws them): on a toy env of a few lines in each
package (episodes truncate and terminate within the rollout and restart
at a fixed obs, so resets agree), with DAPG demos and with zero rewards
(the step rejected, alpha 0); and on door-v0 (2 envs x 2 steps, hidden
(8,)) against the jitted JAX iteration, in float64 and float32.  The
JAX side's advantages, g and CG direction come from its update written
out below, run on the port's trajectory and itself held to the jitted
function's result.

Tolerances (max abs), 2-4x the worst over seeds 0-2 (`python
tests/measure_torch_learner_floors.py npg`), stated beside each test.
"""
import dataclasses
from typing import NamedTuple

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mj_envs_tpu import envs as jenvs
from mj_envs_tpu.algos import networks as JN
from mj_envs_tpu.algos import npg as JNPG
from mj_envs_torch import envs as tenvs
from mj_envs_torch.algos import npg as TNPG
from test_torch_ppo import jax_rollout_draws, max_err, to_port

NP = {torch.float64: np.float64, torch.float32: np.float32}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)    # six xdist workers share the CPU
    yield
    torch.set_num_threads(n)


# -- a toy env in each package ------------------------------------------------

TOY_OBS, TOY_NU, TOY_CAP, TOY_TERM = 5, 3, 3, 0.6


def toy_matrices(seed=11):
    rng = np.random.default_rng(seed)
    return (0.8 * rng.standard_normal((TOY_OBS, TOY_OBS)),
            0.8 * rng.standard_normal((TOY_NU, TOY_OBS)),
            0.1 * np.arange(1, TOY_OBS + 1) / TOY_OBS)


class JToyState(NamedTuple):
    obs: jnp.ndarray
    reward: jnp.ndarray
    done: jnp.ndarray
    step_count: jnp.ndarray
    truncated: jnp.ndarray
    final_obs: jnp.ndarray
    nan_resets: jnp.ndarray


class JToyEnv:
    """obs' = tanh(obs A + clip(a) Bm); reward = scale (obs'[0] - 0.1
    |a|^2); terminates where obs'[1] > 0.6, truncates after 3 steps, and
    restarts at a fixed obs (one env; the learners vmap it)."""
    OBS_DIM, nu, MAX_EPISODE_STEPS = TOY_OBS, TOY_NU, TOY_CAP

    def __init__(self, scale=1.0, dtype=jnp.float64):
        A, Bm, r0 = toy_matrices()
        self.A, self.Bm = jnp.asarray(A, dtype), jnp.asarray(Bm, dtype)
        self.r0, self.scale = jnp.asarray(r0, dtype), scale

    def step_auto_reset(self, s, a):
        a = jnp.clip(a, -1.0, 1.0)
        obs2 = jnp.tanh(s.obs @ self.A + a @ self.Bm)
        reward = self.scale * (obs2[0] - 0.1 * jnp.sum(a * a))
        term = obs2[1] > TOY_TERM
        t2 = s.step_count + 1
        trunc = t2 >= TOY_CAP
        restart = term | trunc
        return JToyState(
            obs=jnp.where(restart, self.r0, obs2), reward=reward,
            done=restart, step_count=jnp.where(restart, 0, t2),
            truncated=trunc & ~term, final_obs=obs2,
            nan_resets=s.nan_resets)


@dataclasses.dataclass
class TToyState:
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    step_count: torch.Tensor
    truncated: torch.Tensor
    final_obs: torch.Tensor
    nan_resets: torch.Tensor

    @property
    def batch(self):
        return self.obs.shape[0]


class TToyEnv:
    """The same toy env, batched, for the port's learners."""
    OBS_DIM, nu, MAX_EPISODE_STEPS = TOY_OBS, TOY_NU, TOY_CAP
    device = torch.device("cpu")

    def __init__(self, scale=1.0, dtype=torch.float64):
        A, Bm, r0 = toy_matrices()
        self.dtype = dtype
        self.A, self.Bm, self.r0 = (torch.as_tensor(x, dtype=dtype)
                                    for x in (A, Bm, r0))
        self.scale = scale

    def generator(self, seed):
        return torch.Generator().manual_seed(seed)

    def step_auto_reset(self, s, a, generator):
        a = torch.clamp(a, -1.0, 1.0)
        obs2 = torch.tanh(s.obs @ self.A + a @ self.Bm)
        reward = self.scale * (obs2[:, 0] - 0.1 * torch.sum(a * a, -1))
        term = obs2[:, 1] > TOY_TERM
        t2 = s.step_count + 1
        trunc = t2 >= TOY_CAP
        restart = term | trunc
        return TToyState(
            obs=torch.where(restart[:, None], self.r0, obs2), reward=reward,
            done=restart,
            step_count=torch.where(restart, torch.zeros_like(t2), t2),
            truncated=trunc & ~term, final_obs=obs2,
            nan_resets=s.nan_resets)


def toy_states(seed, B, dtype):
    """The same start states in both packages: random obs, episode
    steps 0-2."""
    rng = np.random.default_rng(seed)
    obs = rng.uniform(-0.5, 0.5, (B, TOY_OBS)).astype(NP[dtype])
    t = rng.integers(0, TOY_CAP, B).astype(np.int32)
    zb, zi = np.zeros(B, bool), np.zeros(B, np.int32)
    j = JToyState(obs=jnp.asarray(obs), reward=jnp.zeros(B, NP[dtype]),
                  done=jnp.asarray(zb), step_count=jnp.asarray(t),
                  truncated=jnp.asarray(zb), final_obs=jnp.asarray(obs),
                  nan_resets=jnp.asarray(zi))
    tt = TToyState(obs=torch.as_tensor(obs),
                   reward=torch.zeros(B, dtype=dtype),
                   done=torch.as_tensor(zb), step_count=torch.as_tensor(t),
                   truncated=torch.as_tensor(zb),
                   final_obs=torch.as_tensor(obs),
                   nan_resets=torch.as_tensor(zi))
    return j, tt


# -- parameters across the two layouts ---------------------------------------

def jax_npg_params(seed, obs_dim, act_dim, hidden, dtype):
    """The JAX package's initial policy, cast to `dtype`, with a
    perturbed log_std."""
    cfg = JNPG.NPGConfig(hidden=hidden)
    p = JNPG._policy_init(jax.random.PRNGKey(seed), obs_dim, act_dim, cfg)
    p = jax.tree_util.tree_map(lambda x: x.astype(NP[dtype]), p)
    rng = np.random.default_rng(seed + 100)
    p["log_std"] = jnp.asarray(
        (-0.5 + 0.2 * rng.standard_normal(act_dim)).astype(NP[dtype]))
    return p


def _slices(module):
    """name -> (start, shape) of each parameter in the port's flat
    vector (`module.parameters()` order: log_std, then each layer's
    weight (out, in) and bias)."""
    out, i = {}, 0
    for name, p in module.named_parameters():
        out[name] = (i, p.shape)
        i += p.numel()
    return out


def _jax_order(module):
    """The port's parameter names in `ravel_pytree`'s order (each
    layer's b, w; log_std), with whether each is transposed there."""
    names = []
    for k in range(len(module.actor)):
        names += [(f"actor.{k}.bias", False), (f"actor.{k}.weight", True)]
    return names + [("log_std", False)]


def port_flat_to_jax(flat, module):
    """A flat vector of the port's order in `ravel_pytree`'s order."""
    flat = np.asarray(flat.detach().cpu().double() if
                      isinstance(flat, torch.Tensor) else flat)
    sl = _slices(module)
    out = []
    for name, transposed in _jax_order(module):
        i, shape = sl[name]
        x = flat[i:i + shape.numel()].reshape(shape)
        out.append((x.T if transposed else x).reshape(-1))
    return np.concatenate(out)


def jax_flat_to_port_fn(module):
    """The inverse of `port_flat_to_jax` for `module`'s shapes."""
    sl = _slices(module)

    def to_port(flat):
        flat = np.asarray(flat)
        parts, j = {}, 0
        for name, transposed in _jax_order(module):
            shape = tuple(sl[name][1])
            k = int(np.prod(shape))
            x = flat[j:j + k]
            parts[name] = (x.reshape(shape[::-1]).T if transposed
                           else x.reshape(shape)).reshape(-1)
            j += k
        return np.concatenate([parts[n] for n in sl])
    return to_port


def params_error(module, jparams):
    back = TNPG.npg_params_to_numpy(module)
    return max(max_err(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jparams)))


# -- the JAX update written out ----------------------------------------------

def jax_rollout(step, params, es, noise, n_steps):
    """`npg.py:121-136` with the given normals: (env state, trajectory)."""
    out = []
    for t in range(n_steps):
        mean, log_std = JNPG._policy_apply(params, es.obs)
        action = mean + jnp.exp(log_std) * noise[t]
        es2 = step(es, jnp.clip(action, -1.0, 1.0))
        out.append(JNPG.Transition(
            obs=es.obs, action=action, reward=es2.reward, done=es2.done,
            t=es.step_count, truncated=es2.truncated,
            final_obs=es2.final_obs, t_final=es.step_count + 1))
        es = es2
    return es, JNPG.Transition(*(jnp.stack(xs) for xs in zip(*out)))


def jax_update(cfg, params, traj, last_obs, last_t, demos=None,
               iteration=0):
    """`train_iter_fn`'s update (`npg.py:203-277`) written out, returning
    its intermediates."""
    T, B = traj.reward.shape
    flat = jax.tree_util.tree_map(
        lambda x: x.reshape(T * B, *x.shape[2:]), traj)
    rets, ret = [], jnp.zeros_like(traj.reward[0])
    for t in range(T - 1, -1, -1):
        ret = traj.reward[t] + cfg.gamma * ret * (
            1.0 - traj.done[t].astype(traj.reward.dtype))
        rets.insert(0, ret)
    rets = jnp.stack(rets)
    feats = JNPG._baseline_features(flat.obs, flat.t)
    w = JNPG._fit_baseline(feats, rets.reshape(T * B), cfg.baseline_reg)
    values = (feats @ w).reshape(T, B)
    fin = (JNPG._baseline_features(flat.final_obs, flat.t_final)
           @ w).reshape(T, B)
    tb = jnp.where(traj.truncated, fin, 0.0)
    last_value = JNPG._baseline_features(last_obs, last_t) @ w
    advs, adv_next, v_next = [], jnp.zeros_like(last_value), last_value
    for t in range(T - 1, -1, -1):
        nonterm = 1.0 - traj.done[t].astype(values.dtype)
        delta = (traj.reward[t] + cfg.gamma * (v_next * nonterm + tb[t])
                 - values[t])
        adv_next = delta + cfg.gamma * cfg.gae_lambda * nonterm * adv_next
        advs.insert(0, adv_next)
        v_next = values[t]
    advs = jnp.stack(advs).reshape(T * B)
    adv_n = (advs - advs.mean()) / (advs.std() + 1e-8)

    def surrogate(p):
        mean, log_std = JNPG._policy_apply(p, flat.obs)
        return jnp.mean(JN.gaussian_log_prob(mean, log_std, flat.action)
                        * adv_n)

    def mean_logp(p):
        mean, log_std = JNPG._policy_apply(p, demos["obs"])
        return jnp.mean(JN.gaussian_log_prob(mean, log_std,
                                             demos["actions"]))

    g = jax.grad(surrogate)(params)
    demo_w = None
    if demos is not None:
        demo_w = cfg.lam0 * cfg.lam1 ** jnp.asarray(iteration, jnp.float32)
        g = jax.tree_util.tree_map(lambda a, b: a + demo_w * b, g,
                                   jax.grad(mean_logp)(params))
    g_flat, unravel = jax.flatten_util.ravel_pytree(g)
    fvp = jax_fisher_vp(cfg, params, flat.obs, unravel)
    direction = jax_cg(fvp, g_flat, cfg.cg_iters)
    quad = g_flat @ direction
    alpha = jnp.where(quad > 1e-10, jnp.sqrt(
        2.0 * cfg.normalized_step_size / jnp.maximum(quad, 1e-10)), 0.0)
    new = jax.tree_util.tree_map(lambda p, d: p + alpha * d, params,
                                 unravel(direction))
    return dict(advantages=advs.reshape(T, B), g=g_flat,
                direction=direction, quad=quad, alpha=alpha, params=new,
                rets=rets, demo_weight=demo_w)


def jax_fisher_vp(cfg, params, obs, unravel):
    """`fisher_vp` (`npg.py:163-182`)."""
    def outputs(p):
        mean, log_std = JNPG._policy_apply(p, obs)
        return mean, jnp.broadcast_to(log_std, mean.shape)

    mean, log_std = outputs(params)
    inv_var = jnp.exp(-2.0 * log_std)
    _, vjp = jax.vjp(outputs, params)

    def fvp(v_flat):
        _, jv = jax.jvp(outputs, (params,), (unravel(v_flat),))
        (fv,) = vjp((jv[0] * inv_var / mean.shape[0],
                     jv[1] * 2.0 / mean.shape[0]))
        return jax.flatten_util.ravel_pytree(fv)[0] \
            + cfg.cg_damping * v_flat

    return fvp


def jax_cg(mvp, b, iters):
    """`conjugate_gradient` (`npg.py:184-198`)."""
    x, r, p, rs = jnp.zeros_like(b), b, b, b @ b
    for _ in range(iters):
        Ap = mvp(p)
        alpha = rs / jnp.maximum(p @ Ap, 1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = r @ r
        p = r + (rs_new / jnp.maximum(rs, 1e-20)) * p
        rs = rs_new
    return x


# -- baseline --------------------------------------------------------------

def baseline_errors(seed):
    """Features and ridge fit of 128 door-sized rows (39 obs, 82
    features), float64: the features, the weights and the fitted
    values."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((128, 39))
    t = rng.integers(0, 200, 128).astype(np.int32)
    rets = rng.standard_normal(128)
    fj = JNPG._baseline_features(jnp.asarray(obs), jnp.asarray(t))
    wj = JNPG._fit_baseline(fj, jnp.asarray(rets), 1e-3)
    ft = TNPG._baseline_features(torch.as_tensor(obs), torch.as_tensor(t))
    wt = TNPG._fit_baseline(ft, torch.as_tensor(rets), 1e-3)
    return dict(feats=max_err(ft, fj), w=max_err(wt, wj),
                values=max_err(ft @ wt, fj @ wj),
                w_scale=float(np.abs(np.asarray(wj)).max()))


def test_baseline_features_and_fit_match_jax():
    """float64: the features exact (worst 0 over seeds 0-2); the weights
    (up to ~10) worst 9.2e-13, bound 3e-12; the fitted values worst
    1.5e-14, bound 5e-14."""
    e = baseline_errors(0)
    assert e["feats"] == 0.0, e
    assert e["w"] <= 3e-12 and e["values"] <= 5e-14, e


# -- Fisher-vector product and CG --------------------------------------------

def fisher_errors(seed):
    """The JAX test's tiny policy (5 -> 4 -> 2, damping 1e-3), float64:
    the port's F v against the dense Fisher, its 10 CG steps against the
    JAX package's, and 80 steps against the dense solve."""
    cfg = JNPG.NPGConfig(hidden=(4,), cg_damping=1e-3)
    p = jax_npg_params(seed, 5, 2, (4,), torch.float64)
    obs = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 1),
                                       (32, 5)))
    flat0, unravel = jax.flatten_util.ravel_pytree(p)
    n = flat0.shape[0]
    rng = np.random.default_rng(seed + 2)
    g, v = rng.standard_normal((2, n))

    def outputs_flat(f):
        mean, ls = JNPG._policy_apply(unravel(f), jnp.asarray(obs))
        return mean, jnp.broadcast_to(ls, mean.shape)

    Jm = jax.jacobian(lambda f: outputs_flat(f)[0])(flat0)
    Js = jax.jacobian(lambda f: outputs_flat(f)[1])(flat0)
    inv_var = jnp.exp(-2.0 * outputs_flat(flat0)[1])
    F = (jnp.einsum("bai,ba,baj->ij", Jm, inv_var, Jm)
         + 2.0 * jnp.einsum("bai,baj->ij", Js, Js)) / obs.shape[0]
    F = np.asarray(F + cfg.cg_damping * jnp.eye(n))

    mod = TNPG.npg_params_from_numpy(p, device="cpu", dtype=torch.float64)
    to_port = jax_flat_to_port_fn(mod)
    fvp = TNPG.make_fisher_vp(mod, torch.as_tensor(obs.copy()),
                              cfg.cg_damping)
    fv = port_flat_to_jax(fvp(torch.as_tensor(to_port(v))), mod)
    x10 = port_flat_to_jax(TNPG._conjugate_gradient(
        fvp, torch.as_tensor(to_port(g)), 10), mod)
    x80 = port_flat_to_jax(TNPG._conjugate_gradient(
        fvp, torch.as_tensor(to_port(g)), 80), mod)
    jfvp = jax_fisher_vp(cfg, p, jnp.asarray(obs), unravel)
    want10 = jax_cg(jfvp, jnp.asarray(g), 10)
    dense = np.linalg.solve(F, g)
    return dict(fvp=max_err(fv, F @ v), fvp_vs_jax=max_err(
        fv, jfvp(jnp.asarray(v))), cg10=max_err(x10, want10),
        cg80_rel=float(np.abs(x80 - dense).max() / np.abs(dense).max()),
        scale=float(np.abs(dense).max()))


def test_fisher_vp_and_cg_match_jax():
    """float64, worst over seeds 0-2: F v against the dense Fisher
    4.9e-15 and against the JAX product 2.7e-15; 10 CG steps against the
    JAX package's 10 steps 4.1e-12 (a solution of scale ~3e3); 80 steps
    against the dense solve 1.6e-11 relative (the JAX package's own test
    allows 1e-3).  Bounds `FISHER_BOUND`."""
    e = fisher_errors(0)
    for k, b in FISHER_BOUND.items():
        assert e[k] <= b, e


FISHER_BOUND = dict(fvp=2e-14, fvp_vs_jax=1e-14, cg10=1.5e-11,
                    cg80_rel=5e-11)


def test_flat_order_maps_both_ways():
    mod = TNPG.NPGPolicy(7, 3, (5, 4), device="cpu", dtype=torch.float64)
    flat = torch.arange(sum(p.numel() for p in mod.parameters()),
                        dtype=torch.float64)
    back = jax_flat_to_port_fn(mod)(port_flat_to_jax(flat, mod))
    np.testing.assert_array_equal(back, flat.numpy())
    jflat, _ = jax.flatten_util.ravel_pytree(TNPG.npg_params_to_numpy(mod))
    got = port_flat_to_jax(TNPG._flat(mod.parameters()), mod)
    np.testing.assert_array_equal(got, np.asarray(jflat))


# -- whole iterations ---------------------------------------------------------

def run_pair(jenv, tenv, es_j, es_t, cfg, params, dtype, key, demos=None,
             written_out=True, jax_rollout_too=False):
    """One iteration in both packages from the same state, weights and
    normals: the jitted JAX iteration and the port's, with its extras;
    with `written_out` the JAX update written out on the port's
    trajectory (the learner's math on the same inputs), and with
    `jax_rollout_too` the JAX rollout written out."""
    B = es_j.obs.shape[0]
    jdemos = demos and {k: jnp.asarray(v) for k, v in demos.items()}
    _, it_j, _ = JNPG.make_npg(jenv, B, cfg, demos=jdemos)
    js, es_j2, jm = jax.jit(it_j)(
        JNPG.NPGState(params, jnp.zeros((), jnp.int32), key), es_j)
    noise, _ = jax_rollout_draws(key, cfg.n_steps, B, jenv.nu, NP[dtype])

    _, it_t, _ = TNPG.make_npg(tenv, B, TNPG.NPGConfig(**cfg._asdict()),
                               demos=demos, device="cpu")
    mod = TNPG.npg_params_from_numpy(params, device="cpu", dtype=dtype)
    st = TNPG.NPGState(mod, 0, torch.Generator().manual_seed(0),
                       tenv.generator(0))
    ex = {}
    st, es_t2, tm = it_t(st, es_t, noise=torch.as_tensor(noise), extras=ex)
    upd = traj_j = None
    if written_out:
        traj = JNPG.Transition(*(jnp.asarray(x.numpy())
                                 for x in ex["trajectory"]))
        upd = jax_update(cfg, params, traj, jnp.asarray(es_t2.obs.numpy()),
                         jnp.asarray(es_t2.step_count.numpy()), jdemos)
    if jax_rollout_too:
        step = jax.jit(jax.vmap(jenv.step_auto_reset))
        traj_j = jax_rollout(step, params, es_j, noise, cfg.n_steps)[1]
    return dict(js=js, es_j=es_j2, jm=jm, traj_j=traj_j, upd=upd, st=st,
                es_t=es_t2, tm=tm, ex=ex, p0=params)


def iteration_errors(r):
    m = r["st"].module
    e = {}
    if r["traj_j"] is not None:
        e = {f"traj_{f}": max_err(getattr(r["ex"]["trajectory"], f),
                                  getattr(r["traj_j"], f))
             for f in ("obs", "action", "reward", "final_obs")}
    e.update(
        advantages=max_err(r["ex"]["advantages"], r["upd"]["advantages"]),
        g=max_err(port_flat_to_jax(r["ex"]["g"], m), r["upd"]["g"]),
        direction=max_err(port_flat_to_jax(r["ex"]["direction"], m),
                          r["upd"]["direction"]),
        quad=max_err(r["ex"]["quad"], r["upd"]["quad"]),
        params=params_error(m, r["js"].params),
        written_out=max(max_err(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(r["upd"]["params"]),
            jax.tree_util.tree_leaves(r["js"].params))),
        moved=params_error(m, r["p0"]))
    for k in r["jm"]:
        e[k] = max_err(r["tm"][k], r["jm"][k])
    e["dir_scale"] = float(np.abs(np.asarray(r["upd"]["direction"])).max())
    return e


def toy_pair(seed, dtype=torch.float64, scale=1.0, demos=False):
    cfg = JNPG.NPGConfig(n_steps=4, hidden=(8,))
    es_j, es_t = toy_states(seed, 6, dtype)
    params = jax_npg_params(seed, TOY_OBS, TOY_NU, cfg.hidden, dtype)
    d = None
    if demos:
        rng = np.random.default_rng(seed + 5)
        d = {"obs": rng.uniform(-0.5, 0.5, (16, TOY_OBS)).astype(NP[dtype]),
             "actions": rng.uniform(-1, 1, (16, TOY_NU)).astype(NP[dtype])}
    r = run_pair(JToyEnv(scale, NP[dtype]), TToyEnv(scale, dtype), es_j,
                 es_t, cfg, params, dtype, jax.random.PRNGKey(seed + 2), d,
                 jax_rollout_too=True)
    r["demos"] = d
    return r


def toy_errors(seed, demos=False):
    r = toy_pair(seed, demos=demos)
    e = iteration_errors(r)
    tr = r["traj_j"]
    flags = dict(done=int(np.asarray(tr.done).sum()),
                 truncated=int(np.asarray(tr.truncated).sum()))
    e["obs_after"] = max_err(r["es_t"].obs, r["es_j"].obs)
    return e, flags


@pytest.mark.parametrize("demos", [False, True], ids=["npg", "dapg"])
def test_toy_iteration_matches_jax(demos):
    """6 toy envs x 4 steps, float64, with episodes that truncate and
    terminate inside the rollout (the truncation bootstrap from
    final_obs and the termination cut both in play), without and with 16
    DAPG demo pairs: the trajectory, advantages, g, direction, quad, the
    new params and every metric at `TOY_BOUND`.  Worst over seeds 0-2:
    the trajectory 3.1e-16, advantages 2.0e-14, g 2.2e-15; the CG
    direction 1.4e-10 on a scale of ~1 (a 10-step CG on the toy's
    ill-conditioned Fisher amplifies the last bits), quad 1.5e-10,
    params 8.8e-11, KL 2.6e-11, step_size 5.6e-11.  The JAX package's
    own update written out differs from its jitted iteration as much
    (7.4e-11)."""
    e, flags = toy_errors(0, demos)
    assert flags["done"] > flags["truncated"] > 0, flags
    assert e["moved"] > 1e-3, e
    check_bounds(e, TOY_BOUND)


def check_bounds(e, bounds):
    over = {k: (v, bounds[k]) for k, v in e.items()
            if k in bounds and not v <= bounds[k]}
    missing = set(e) - set(bounds) - {"moved", "dir_scale"}
    assert not over and not missing, (e, over, missing)


TOY_BOUND = dict(traj_obs=1e-15, traj_action=1e-15, traj_reward=1e-15,
                 traj_final_obs=1e-15, advantages=6e-14, g=1e-14,
                 direction=5e-10, quad=5e-10, params=3e-10,
                 written_out=3e-10, kl=1e-10, step_size=2e-10,
                 mean_reward=2e-16, mean_return=5e-16, grad_norm=1e-14,
                 nan_resets=0.0, obs_after=1e-15)


def test_zero_reward_rejects_the_step():
    """Zero rewards: the baseline fits 0, the advantages and g vanish, so
    quad <= 1e-10 and both packages take alpha 0 (`npg.py:253-257`): the
    params stay bit for bit, the KL is 0."""
    r = toy_pair(1, scale=0.0)
    assert float(r["jm"]["step_size"]) == 0.0
    assert float(r["tm"]["step_size"]) == 0.0
    assert float(r["ex"]["quad"]) <= 1e-10
    assert float(r["tm"]["kl"]) == 0.0 == float(r["jm"]["kl"])
    assert params_error(r["st"].module, r["p0"]) == 0.0
    assert max_err(r["tm"]["grad_norm"], r["jm"]["grad_norm"]) == 0.0


# door-v0: 2 envs x 2 steps, hidden (8,).
DOOR_CFG = dict(n_steps=2, hidden=(8,))
_DOOR = {}


def door_pair(dtype, seed=0, demos=False, written_out=True):
    if (dtype, seed, demos) in _DOOR:
        return _DOOR[dtype, seed, demos]
    f = jnp.dtype(NP[dtype])
    jenv = jenvs.make("door-v0", dtype=f)
    tenv = tenvs.make("door-v0", device="cpu", dtype=dtype)
    cfg = JNPG.NPGConfig(**DOOR_CFG)
    es_j = jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(seed + 1), 2))
    params = jax_npg_params(seed, jenv.OBS_DIM, jenv.nu, cfg.hidden, dtype)
    d = None
    if demos:
        rng = np.random.default_rng(seed + 5)
        d = {"obs": np.asarray(es_j.obs)[rng.integers(0, 2, 32)]
             + 0.05 * rng.standard_normal((32, jenv.OBS_DIM)),
             "actions": rng.uniform(-1, 1, (32, jenv.nu))}
        d = {k: v.astype(NP[dtype]) for k, v in d.items()}
    r = run_pair(jenv, tenv, es_j, to_port(es_j, dtype), cfg, params, dtype,
                 jax.random.PRNGKey(seed + 2), d, written_out)
    _DOOR[dtype, seed, demos] = r
    return r


def door_errors(dtype, seed=0, demos=False):
    r = door_pair(dtype, seed, demos)
    e = iteration_errors(r)
    e["qpos"] = max_err(r["es_t"].data.qpos, r["es_j"].data.qpos)
    e["qvel"] = max_err(r["es_t"].data.qvel, r["es_j"].data.qvel)
    return e


# Bounds of the float64 door-v0 iteration, 2-4x the worst over seeds
# 0-2 (the rewards and returns agreed exactly at all three: bound 1e-15).
DOOR_F64 = dict(advantages=2e-14, g=1e-13, direction=1e-12, quad=5e-13,
                params=6e-14, written_out=5e-14, kl=1e-14, step_size=2e-15,
                mean_reward=1e-15, mean_return=1e-15, grad_norm=1e-13,
                nan_resets=0.0, qpos=2e-16, qvel=5e-14)


def check_door(e, bounds):
    assert e["moved"] > 1e-4, e
    check_bounds(e, bounds)


def test_door_iteration_matches_jax_f64():
    """door-v0, float64 (both packages' oracle-parity path), against the
    jitted JAX iteration (params, metrics, env state) and its update
    written out on the port's trajectory (advantages, g, direction,
    quad).  Worst over seeds 0-2: advantages 4.4e-15, g 3.0e-14, the
    direction 3.0e-13 (scale up to 20), quad 1.3e-13, params 2.0e-14
    (the step moves them by up to 1.7), KL 3.1e-15, qvel 1.6e-14;
    bounds `DOOR_F64`."""
    check_door(door_errors(torch.float64), DOOR_F64)


def door_f32_errors(seed=0):
    r = door_pair(torch.float32, seed, written_out=False)
    e = {f: max_err(getattr(r["es_t"].data, f), getattr(r["es_j"].data, f))
         for f in ("qpos", "qvel")}
    e["obs"] = max_err(r["es_t"].obs, r["es_j"].obs)
    e["params"] = params_error(r["st"].module, r["js"].params)
    e["moved"] = params_error(r["st"].module, r["p0"])
    for k in ("mean_reward", "step_size", "kl"):
        e[k] = max_err(r["tm"][k], r["jm"][k])
    return e


def test_door_iteration_matches_jax_f32():
    """The same iteration in float32: the env state after it at
    `tests/test_torch_door.py`'s step bounds (rtol 1e-3 / atol 2e-3), the
    rollout's rewards too, and the step taken in both; the params after
    it within 8e-5 and the step size within 4e-6 (worst over seeds 0-2
    2.2e-5 of a step of up to 1.6, and 1.1e-6)."""
    e = door_f32_errors()
    assert e["params"] <= 8e-5 and e["step_size"] <= 4e-6, e
    r = door_pair(torch.float32, written_out=False)
    for f in ("qpos", "qvel"):
        np.testing.assert_allclose(getattr(r["es_t"].data, f).numpy(),
                                   np.asarray(getattr(r["es_j"].data, f)),
                                   rtol=1e-3, atol=2e-3, err_msg=f)
    np.testing.assert_allclose(r["es_t"].obs.numpy(),
                               np.asarray(r["es_j"].obs),
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(float(r["tm"]["mean_reward"]),
                               float(r["jm"]["mean_reward"]), rtol=1e-3,
                               atol=2e-3)
    assert float(r["tm"]["step_size"]) > 0 and float(r["jm"]["step_size"]) > 0


def test_make_npg_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        TNPG.make_npg(TToyEnv(), 2)
