"""Natural policy gradient and DAPG of the PyTorch port
(`mj_envs_tpu/algos/npg.py`).

One iteration rolls `n_steps` auto-reset env steps of `num_envs` envs
(in chunks of 512, as the JAX package's `chunked_vmap`), fits mjrl's
linear feature baseline to this batch's discounted returns, computes GAE
with the truncation bootstrap from `final_obs`, and takes mjrl's
normalized natural-gradient step: `cg_iters` conjugate-gradient steps on
Fisher-vector products (the Gauss-Newton form F = J^T diag(s) J of the
diagonal Gaussian), then alpha = sqrt(2 delta / g^T F^-1 g), or 0 where
that quadratic form is not above 1e-10.  With demos it is DAPG: the
policy gradient gains lam0 * lam1^k times the demos' mean log-prob
gradient.

Where the JAX package jits one function, this is a host loop of batched
torch ops on the env's device; the physics substeps inside each env step
launch the port's CUDA kernels.  Randomness is explicit: the action
normals come from `NPGState.generator` and the auto-resets from
`NPGState.reset_generator`; `train_iter_fn` takes the (T, B, nu) normals
as `noise` in their place, so a test can feed the JAX package's draws.

The flat parameter vector (g, the CG direction) follows
`module.parameters()`: `log_std` (the module's own parameter) first,
then each actor layer's weight (out, in) and bias.
`jax.flatten_util.ravel_pytree` orders the JAX tree by sorted key
instead: each layer's `b`, then `w` (in, out), `log_std` last.  Only the
sum order of the dot products differs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, jvp, vjp

from . import networks as N
from . import ppo as PPO
from .ppo import check_device
from ..envs.base import AdroitEnv, EnvState
from ..parallel.vector import _chunked
from ..trace import Clock

STEP_CHUNK = 512     # envs per chunk of the batched step (`npg.py:107`)


class NPGConfig(NamedTuple):
    normalized_step_size: float = 0.1    # delta (mjrl default 0.01-0.1)
    gamma: float = 0.995
    gae_lambda: float = 0.97
    n_steps: int = 64                    # rollout length per iteration
    cg_iters: int = 10
    cg_damping: float = 1e-4
    hidden: Tuple[int, ...] = (32, 32)
    init_log_std: float = -0.5
    baseline_reg: float = 1e-3
    # DAPG demo-augmentation (used only when demos are passed):
    lam0: float = 1e-2
    lam1: float = 0.95


class NPGPolicy(nn.Module):
    """mjrl's Gaussian MLP (`_policy_init` :71): a tanh MLP whose last
    layer is scaled by 0.01, and a state-independent `log_std`."""

    def __init__(self, obs_dim: int, act_dim: int,
                 hidden: Tuple[int, ...] = (32, 32),
                 init_log_std: float = -0.5,
                 generator: Optional[torch.Generator] = None,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        device = torch.device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.actor = N._mlp((obs_dim, *hidden, act_dim), 0.01, generator,
                            device, dtype)
        self.log_std = nn.Parameter(
            torch.full((act_dim,), init_log_std, device=device, dtype=dtype))

    def forward(self, obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (mean (..., act_dim), log_std (act_dim,))."""
        return N._mlp_apply(self.actor, obs), self.log_std


@dataclasses.dataclass
class NPGState:
    module: NPGPolicy
    iteration: int                     # for the DAPG lam1^k decay
    generator: torch.Generator         # action noise
    reset_generator: torch.Generator   # the env's auto-resets


class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor        # the sampled action, unclipped
    reward: torch.Tensor
    done: torch.Tensor
    t: torch.Tensor             # per-env episode step (baseline feats)
    truncated: torch.Tensor     # boundary was the episode cap
    final_obs: torch.Tensor     # finishing obs at boundaries
    t_final: torch.Tensor       # finishing step index (baseline feats)


def _baseline_features(obs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """mjrl LinearBaseline features: [o, o^2, t, t^2, t^3, 1] with t
    scaled by 1e-3 (`_baseline_features` :83)."""
    al = t[..., None].to(obs.dtype) / 1000.0
    return torch.cat([obs, obs * obs, al, al ** 2, al ** 3,
                      torch.ones_like(al)], dim=-1)


def _fit_baseline(feats: torch.Tensor, returns: torch.Tensor,
                  reg: float) -> torch.Tensor:
    """Ridge least squares, (N, F) @ w ~= (N,) (`_fit_baseline` :91)."""
    F = feats.shape[-1]
    A = feats.T @ feats + reg * torch.eye(F, dtype=feats.dtype,
                                          device=feats.device)
    return torch.linalg.solve(A, feats.T @ returns)


def _disc_returns(cfg: NPGConfig, reward: torch.Tensor,
                  done: torch.Tensor) -> torch.Tensor:
    """Discounted returns over a (T, B) trajectory, cut at every
    boundary (`disc_returns` :212)."""
    rets = torch.empty_like(reward)
    ret = torch.zeros_like(reward[0])
    for t in range(reward.shape[0] - 1, -1, -1):
        ret = reward[t] + cfg.gamma * ret * (1.0 - done[t].to(reward.dtype))
        rets[t] = ret
    return rets


def _conjugate_gradient(mvp, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Exactly `iters` CG steps from 0 with the JAX package's two guards
    (:184-198); no early exit."""
    x = torch.zeros_like(b)
    r, p = b.clone(), b.clone()
    rs = b @ b
    for _ in range(iters):
        Ap = mvp(p)
        alpha = rs / torch.clamp(p @ Ap, min=1e-20)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = r @ r
        p = r + (rs_new / torch.clamp(rs, min=1e-20)) * p
        rs = rs_new
    return x


def _flat(ts) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in ts])


def _mean_logp(module, obs, act):
    mean, log_std = module(obs)
    return torch.mean(N.gaussian_log_prob(mean, log_std, act))


def make_fisher_vp(module: NPGPolicy, obs: torch.Tensor, damping: float):
    """v_flat -> F v + damping v at the module's current params, F the
    Gauss-Newton Fisher of (mean, log_std) over the rows of `obs`
    (`fisher_vp` :163-182): J v by forward mode, J^T (s * J v) by the
    reverse mode of the same function; the params are not changed."""
    names = [n for n, _ in module.named_parameters()]
    params = {n: p.detach() for n, p in module.named_parameters()}
    shapes = [p.shape for p in params.values()]

    def outputs(p):
        mean, log_std = functional_call(module, p, (obs,))
        return mean, log_std.expand_as(mean)

    (mean, log_std), pullback = vjp(outputs, params)
    inv_var = torch.exp(-2.0 * log_std)
    n = mean.shape[0]

    def fvp(v_flat: torch.Tensor) -> torch.Tensor:
        v, i = {}, 0
        for name, shape in zip(names, shapes):
            k = shape.numel()
            v[name] = v_flat[i:i + k].view(shape)
            i += k
        _, (jm, js) = jvp(outputs, (params,), (v,))
        (fv,) = pullback((jm * inv_var / n, js * 2.0 / n))
        return _flat(fv[name] for name in names) + damping * v_flat

    return fvp


def make_npg(env: AdroitEnv, num_envs: int, cfg: NPGConfig = NPGConfig(),
             demos: Optional[Dict[str, torch.Tensor]] = None,
             device="cuda"):
    """Build (init_fn, train_iter_fn, act_fn) for `env` on `device` (the
    card unless the caller asks for the CPU; the env must be on it).
    With `demos` = {"obs": (D, obs_dim), "actions": (D, nu)} the update
    is DAPG.

    init_fn(seed) -> NPGState.  train_iter_fn(state, env_state,
    noise=None, timings=None, extras=None) -> (state, env_state,
    metrics): one iteration, the module updated in place; the metrics
    are the JAX package's six and quad = g . F^-1 g.  `timings`
    receives the ms of the rollout and of the update, and the update's
    parts: the baseline fit with GAE, the gradient, and the CG with the
    step; `extras` the trajectory, the advantages, g, the CG direction,
    quad, the demo weight and the baseline's weights."""
    dev = check_device(env, device)
    if demos is not None:
        demos = {k: torch.as_tensor(v, device=dev, dtype=env.dtype)
                 for k, v in demos.items()}

    def init_fn(seed: int) -> NPGState:
        gen = torch.Generator(device=dev).manual_seed(seed)
        module = NPGPolicy(env.OBS_DIM, env.nu, cfg.hidden, cfg.init_log_std,
                           generator=gen, device=dev, dtype=env.dtype)
        return NPGState(module=module, iteration=0, generator=gen,
                        reset_generator=env.generator(seed + 1))

    def rollout(state: NPGState, env_state: EnvState, noise=None):
        out = []
        with torch.no_grad():
            es = env_state
            for t in range(cfg.n_steps):
                action = act_fn(state.module, es.obs, state.generator,
                                None if noise is None else noise[t])
                es2 = _chunked(env.step_auto_reset, es,
                               torch.clamp(action, -1.0, 1.0), STEP_CHUNK,
                               state.reset_generator)
                out.append(Transition(
                    obs=es.obs, action=action, reward=es2.reward,
                    done=es2.done, t=es.step_count,
                    truncated=es2.truncated, final_obs=es2.final_obs,
                    t_final=es.step_count + 1))
                es = es2
        return es, Transition(*(torch.stack(xs) for xs in zip(*out)))

    def train_iter_fn(state: NPGState, env_state: EnvState, noise=None,
                      timings: Optional[Dict] = None,
                      extras: Optional[Dict] = None):
        clock = Clock(dev) if timings is not None else None
        env_state, traj = rollout(state, env_state, noise)
        if clock:
            timings["rollout_ms"] = clock.lap()
        metrics = update(cfg, state.module, traj, env_state, demos,
                         state.iteration, clock, timings, extras)
        state.iteration += 1
        return state, env_state, metrics

    return init_fn, train_iter_fn, act_fn


def update(cfg: NPGConfig, module: NPGPolicy, traj: Transition,
           env_state: EnvState, demos: Optional[Dict] = None,
           iteration: int = 0, clock: Optional[Clock] = None,
           timings: Optional[Dict] = None,
           extras: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """The update of one iteration from its (T, B) trajectory and the env
    state after it (for the last value), the module stepped in place:
    the baseline fit with GAE, the gradient (with the demo term of
    iteration `iteration`), the CG and the step.  Returns the metrics;
    `timings` (with `clock`) and `extras` as `train_iter_fn`'s."""
    T, B = traj.reward.shape
    flat = Transition(*(x.reshape((T * B,) + x.shape[2:]) for x in traj))
    params = list(module.parameters())

    with torch.no_grad():
        rets = _disc_returns(cfg, traj.reward, traj.done)
        feats = _baseline_features(flat.obs, flat.t)
        w = _fit_baseline(feats, rets.reshape(T * B), cfg.baseline_reg)
        values = (feats @ w).reshape(T, B)
        fin_values = (_baseline_features(flat.final_obs, flat.t_final)
                      @ w).reshape(T, B)
        trunc_boots = torch.where(traj.truncated, fin_values,
                                  torch.zeros_like(fin_values))
        last_value = _baseline_features(env_state.obs,
                                        env_state.step_count) @ w
        # PPO's GAE (`gae` :138 is the same recursion): the boundary
        # value is 0 at a termination or quarantine and V(final_obs) at
        # a pure truncation.
        advs = PPO._gae(cfg, PPO.Transition(
            obs=None, action=None, log_prob=None, value=values,
            reward=traj.reward, done=traj.done, trunc_boot=trunc_boots),
            last_value)[0].reshape(T * B)
        adv_n = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)
    if clock:
        timings["baseline_ms"] = clock.lap()

    # Vanilla policy gradient (+ the DAPG demo term).
    mean, log_std = module(flat.obs)
    surrogate = torch.mean(
        N.gaussian_log_prob(mean, log_std, flat.action) * adv_n)
    g = torch.autograd.grad(surrogate, params)
    demo_w = None
    if demos is not None:
        # lam0 * lam1^k in float32, as the JAX package computes it.
        demo_w = (torch.tensor(cfg.lam1, dtype=torch.float32)
                  ** float(iteration) * cfg.lam0).item()
        g_demo = torch.autograd.grad(
            _mean_logp(module, demos["obs"], demos["actions"]), params)
        g = [a + demo_w * b for a, b in zip(g, g_demo)]
    g_flat = _flat(g).detach()
    if clock:
        timings["gradient_ms"] = clock.lap()

    # The old policy for the KL (log_std changes in place below).
    mean_o, ls_o = mean.detach(), log_std.detach().clone()
    fvp = make_fisher_vp(module, flat.obs, cfg.cg_damping)
    npg_dir = _conjugate_gradient(fvp, g_flat, cfg.cg_iters)
    with torch.no_grad():
        quad = g_flat @ npg_dir
        # A non-positive or vanishing curvature would send the step
        # size to ~1e10: reject the step (alpha 0), as the JAX
        # package does.
        alpha = torch.where(
            quad > 1e-10,
            torch.sqrt(2.0 * cfg.normalized_step_size
                       / torch.clamp(quad, min=1e-10)),
            torch.zeros_like(quad))
        i = 0
        for p in params:
            k = p.numel()
            p.add_(alpha * npg_dir[i:i + k].view(p.shape))
            i += k

        # Approximate KL of the step (for diagnostics).
        mean_n, ls_n = module(flat.obs)
        kl = torch.mean(torch.sum(
            ls_n - ls_o + (torch.exp(2 * ls_o) + (mean_o - mean_n) ** 2)
            / (2.0 * torch.exp(2 * ls_n)) - 0.5, dim=-1))
        # The JAX package's six metrics, and quad (the guard's input).
        metrics = dict(
            mean_reward=traj.reward.mean(), mean_return=rets[0].mean(),
            step_size=alpha, kl=kl, grad_norm=torch.linalg.norm(g_flat),
            nan_resets=env_state.nan_resets.sum(), quad=quad)
    if clock:
        timings["cg_ms"] = clock.lap()
        timings["update_ms"] = (timings["baseline_ms"]
                                + timings["gradient_ms"]
                                + timings["cg_ms"])
    if extras is not None:
        extras.update(trajectory=traj, advantages=advs.reshape(T, B),
                      g=g_flat, direction=npg_dir, quad=quad,
                      demo_weight=demo_w, baseline_w=w)
    return metrics


def act_fn(module: NPGPolicy, obs, generator, noise=None):
    """A Gaussian draw around the policy's mean (`noise` in place of
    the generator's normals when given)."""
    mean, log_std = module(obs)
    return N.gaussian_sample(mean, log_std, generator, noise)


def npg_params_to_numpy(module: NPGPolicy) -> Dict:
    """The JAX package's tree {"actor": [{"w": (in, out), "b": (out,)},
    ...], "log_std": (act_dim,)}."""
    return {"actor": N.mlp_to_numpy(module.actor),
            "log_std": module.log_std.detach().cpu().numpy().copy()}


def npg_params_from_numpy(params: Dict, device="cuda",
                          dtype=torch.float32) -> NPGPolicy:
    """An NPGPolicy holding `params`, a JAX-layout tree of arrays."""
    actor = params["actor"]
    sizes = [np.shape(actor[0]["w"])[0]] + [np.shape(p["w"])[1]
                                            for p in actor]
    module = NPGPolicy(sizes[0], sizes[-1], tuple(sizes[1:-1]),
                       device=device, dtype=dtype)
    N._copy_layers(module.actor, actor)
    with torch.no_grad():
        module.log_std.copy_(torch.as_tensor(np.array(params["log_std"])))
    return module
