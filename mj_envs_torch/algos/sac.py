"""Soft actor-critic of the PyTorch port (`mj_envs_tpu/algos/sac.py`).

A tanh-squashed Gaussian actor, twin Q critics with a polyak-averaged
target, automatic temperature tuning to a target entropy of -nu, and a
fixed-capacity replay ring on the env's device.  One iteration collects
`steps_per_iter` auto-reset env steps of `num_envs` envs (uniform random
actions while fewer than `warmup_steps` env steps were taken), then runs
`updates_per_iter` gradient updates once the ring holds `batch_size`
transitions.

The ring's write head and size and the env-step count are host ints:
they follow from the step counts alone, so neither the warm-up test nor
the update gate reads the device.  The three optimizers are
`torch.optim.Adam` (b1 0.9, b2 0.999, eps 1e-8), which computes optax's
`adam` update.  The target critic is a deep copy of the critic at
init (the JAX package starts it as the same arrays).

Randomness is explicit: the policy normals, the warm-up uniforms, the
replay indices and the update normals come from `SACState.generator`,
the auto-resets from `SACState.reset_generator`; `train_iter_fn` takes
every one of those draws in `draws` in their place, so a test can feed
the JAX package's.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import networks as N
from .ppo import check_device
from ..envs.base import AdroitEnv, EnvState
from ..parallel.vector import _chunked
from ..trace import Clock

STEP_CHUNK = 512     # envs per chunk of the batched step (`sac.py:94`)
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


class SACConfig(NamedTuple):
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005            # polyak
    hidden: Tuple[int, ...] = (256, 256)
    buffer_size: int = 100_000    # transitions (across all envs)
    batch_size: int = 256
    steps_per_iter: int = 16      # env steps per train_iter (per env)
    updates_per_iter: int = 16
    warmup_steps: int = 1_000     # random actions until this many stored
    log_std_min: float = -20.0
    log_std_max: float = 2.0


@dataclasses.dataclass
class Replay:
    """Ring buffer of transitions on the env's device."""
    obs: torch.Tensor       # (cap, obs_dim)
    action: torch.Tensor    # (cap, act_dim)
    reward: torch.Tensor    # (cap,)
    next_obs: torch.Tensor  # (cap, obs_dim)
    done: torch.Tensor      # (cap,) bool
    idx: int                # write head
    size: int               # valid entries

    @classmethod
    def empty(cls, cap: int, obs_dim: int, act_dim: int, device,
              dtype) -> "Replay":
        z = dict(device=device, dtype=dtype)
        return cls(obs=torch.zeros(cap, obs_dim, **z),
                   action=torch.zeros(cap, act_dim, **z),
                   reward=torch.zeros(cap, **z),
                   next_obs=torch.zeros(cap, obs_dim, **z),
                   done=torch.zeros(cap, dtype=torch.bool, device=device),
                   idx=0, size=0)

    def store(self, obs, action, reward, next_obs, done):
        """Append a (B,) batch at the head (`_store` :131), in place."""
        B, cap = obs.shape[0], self.obs.shape[0]
        at = (self.idx + torch.arange(B, device=self.obs.device)) % cap
        self.obs[at] = obs
        self.action[at] = action
        self.reward[at] = reward
        self.next_obs[at] = next_obs
        self.done[at] = done
        self.idx = (self.idx + B) % cap
        self.size = min(self.size + B, cap)


@dataclasses.dataclass
class SACState:
    actor: nn.ModuleList           # relu MLP to 2 nu (mean, log_std)
    critic: nn.ModuleDict          # {"q1": mlp, "q2": mlp}
    target_critic: nn.ModuleDict
    log_alpha: nn.Parameter        # ()
    opt_actor: torch.optim.Optimizer
    opt_critic: torch.optim.Optimizer
    opt_alpha: torch.optim.Optimizer
    replay: Replay
    env_steps: int
    generator: torch.Generator         # every draw of the learner
    reset_generator: torch.Generator   # the env's auto-resets


def _actor_dist(actor: nn.ModuleList, obs, act_dim: int, cfg: SACConfig):
    out = N._mlp_apply(actor, obs, torch.relu)
    mean, log_std = out[..., :act_dim], out[..., act_dim:]
    return mean, torch.clamp(log_std, cfg.log_std_min, cfg.log_std_max)


def _sample_tanh(mean, log_std, noise):
    """Reparameterized tanh-Gaussian sample and its log-prob, from
    standard normals `noise` (`_sample_tanh` :74)."""
    std = torch.exp(log_std)
    z = mean + std * noise
    a = torch.tanh(z)
    logp = torch.sum(
        -0.5 * ((z - mean) / std) ** 2 - log_std - _HALF_LOG_2PI
        - torch.log(torch.clamp(1 - a ** 2, min=1e-6)), dim=-1)
    return a, logp


def _q_apply(critic: nn.ModuleDict, obs, act):
    x = torch.cat([obs, act], dim=-1)
    return (N._mlp_apply(critic["q1"], x, torch.relu)[..., 0],
            N._mlp_apply(critic["q2"], x, torch.relu)[..., 0])


def _adam(params, cfg: SACConfig):
    return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)


def _update_once(cfg: SACConfig, st: SACState, sel, noise_next,
                 noise_actor) -> Dict[str, torch.Tensor]:
    """One update (`_update_once` :146) on the transitions `sel` of the
    ring, in place: the critic's Adam step on the target of the old actor
    and the target critic, the actor's against the updated critic, the
    temperature's from the actor loss's log-probs, then the polyak
    target.  `alpha` is exp(log_alpha) before the update throughout.
    Returns its metrics."""
    act_dim = st.replay.action.shape[1]
    target_entropy = -float(act_dim)
    rp = st.replay
    obs, act, rew = rp.obs[sel], rp.action[sel], rp.reward[sel]
    # float32 as in the JAX package, whose float64 path thereby discounts
    # by gamma rounded to float32.
    nobs, done = rp.next_obs[sel], rp.done[sel].to(torch.float32)
    with torch.no_grad():
        alpha = torch.exp(st.log_alpha)        # before this update
        mean_n, ls_n = _actor_dist(st.actor, nobs, act_dim, cfg)
        a_n, logp_n = _sample_tanh(mean_n, ls_n, noise_next)
        q1_t, q2_t = _q_apply(st.target_critic, nobs, a_n)
        target = rew + cfg.gamma * (1 - done) * (
            torch.minimum(q1_t, q2_t) - alpha * logp_n)

    # Critic.
    q1, q2 = _q_apply(st.critic, obs, act)
    cl = torch.mean((q1 - target) ** 2 + (q2 - target) ** 2)
    st.opt_critic.zero_grad(set_to_none=False)
    cl.backward()
    st.opt_critic.step()

    # Actor, against the updated critic; gradients into the actor
    # only.
    mean, ls = _actor_dist(st.actor, obs, act_dim, cfg)
    a, logp = _sample_tanh(mean, ls, noise_actor)
    q1, q2 = _q_apply(st.critic, obs, a)
    al = torch.mean(alpha * logp - torch.minimum(q1, q2))
    st.opt_actor.zero_grad(set_to_none=False)
    al.backward(inputs=list(st.actor.parameters()))
    st.opt_actor.step()

    # Temperature, from the actor loss's log-probs (old actor).
    tl = -torch.mean(torch.exp(st.log_alpha)
                     * (logp.detach() + target_entropy))
    st.opt_alpha.zero_grad(set_to_none=False)
    tl.backward()
    st.opt_alpha.step()

    with torch.no_grad():
        for t, o in zip(st.target_critic.parameters(),
                        st.critic.parameters()):
            t.copy_((1 - cfg.tau) * t + cfg.tau * o)
        return dict(critic_loss=cl.detach(), actor_loss=al.detach(),
                    alpha=torch.exp(st.log_alpha))


def make_sac(env: AdroitEnv, num_envs: int, cfg: SACConfig = SACConfig(),
             device="cuda"):
    """Build (init_fn, train_iter_fn, act_fn) for `env` on `device` (the
    card unless the caller asks for the CPU; the env must be on it).

    init_fn(seed) -> SACState.  train_iter_fn(state, env_state,
    draws=None, timings=None) -> (state, env_state, metrics): one
    iteration, the state updated in place.  `draws`, when given, holds
    every draw of the iteration: "policy" and "uniform" (S, B, nu), the
    policy's normals and the warm-up uniforms in [-1, 1) of each collect
    step (both drawn, as the JAX package draws both), and "sel" (U,
    batch), "next" and "actor" (U, batch, nu), each update's replay
    indices and the normals of its target's next action and of its
    actor loss.  `timings` receives the ms of the collection and of the
    updates."""
    dev = check_device(env, device)
    obs_dim, act_dim, dtype = env.OBS_DIM, env.nu, env.dtype

    def init_fn(seed: int) -> SACState:
        gen = torch.Generator(device=dev).manual_seed(seed)
        actor = N._mlp((obs_dim, *cfg.hidden, 2 * act_dim), 0.01, gen, dev,
                       dtype)
        critic = nn.ModuleDict({
            q: N._mlp((obs_dim + act_dim, *cfg.hidden, 1), 1.0, gen, dev,
                      dtype) for q in ("q1", "q2")})
        log_alpha = nn.Parameter(torch.zeros((), device=dev, dtype=dtype))
        return SACState(
            actor=actor, critic=critic, target_critic=copy.deepcopy(critic),
            log_alpha=log_alpha, opt_actor=_adam(actor.parameters(), cfg),
            opt_critic=_adam(critic.parameters(), cfg),
            opt_alpha=_adam([log_alpha], cfg),
            replay=Replay.empty(cfg.buffer_size, obs_dim, act_dim, dev,
                                dtype),
            env_steps=0, generator=gen,
            reset_generator=env.generator(seed + 1))

    def act_fn(actor, obs, generator, noise=None):
        mean, log_std = _actor_dist(actor, obs, act_dim, cfg)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device, dtype=mean.dtype)
        return _sample_tanh(mean, log_std, noise)[0]

    def normals(gen, *shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def train_iter_fn(st: SACState, env_state: EnvState,
                      draws: Optional[Dict[str, torch.Tensor]] = None,
                      timings: Optional[Dict] = None):
        clock = Clock(dev) if timings is not None else None
        gen = st.generator
        if draws is not None:
            draws = {k: v.to(dev) for k, v in draws.items()}
        rews = []
        es = env_state
        with torch.no_grad():
            for s in range(cfg.steps_per_iter):
                if draws is None:
                    a_pol = act_fn(st.actor, es.obs, gen)
                    a_rand = 2.0 * torch.rand(num_envs, act_dim,
                                              generator=gen, device=dev,
                                              dtype=dtype) - 1.0
                else:
                    a_pol = act_fn(st.actor, es.obs, gen, draws["policy"][s])
                    a_rand = draws["uniform"][s].to(dtype)
                a = a_rand if st.env_steps < cfg.warmup_steps else a_pol
                es2 = _chunked(env.step_auto_reset, es, a, STEP_CHUNK,
                               st.reset_generator)
                # At a pure truncation the stored next_obs is the
                # finishing obs and done stays 0, so the target keeps
                # bootstrapping.
                next_obs = torch.where(es2.truncated[:, None],
                                       es2.final_obs, es2.obs)
                st.replay.store(es.obs, a, es2.reward, next_obs,
                                es2.done & ~es2.truncated)
                st.env_steps += num_envs
                rews.append(es2.reward.mean())
                es = es2
        if clock:
            timings["collect_ms"] = clock.lap()

        if st.replay.size >= cfg.batch_size:
            per: Dict[str, list] = {}
            for u in range(cfg.updates_per_iter):
                if draws is None:
                    sel = torch.randint(0, max(st.replay.size, 1),
                                        (cfg.batch_size,), generator=gen,
                                        device=dev)
                    nn_, na = (normals(gen, cfg.batch_size, act_dim)
                               for _ in range(2))
                else:
                    sel, nn_, na = (draws["sel"][u], draws["next"][u],
                                    draws["actor"][u])
                for k, v in _update_once(cfg, st, sel, nn_, na).items():
                    per.setdefault(k, []).append(v)
            metrics = {k: torch.stack(v).mean() for k, v in per.items()}
        else:
            zero = torch.zeros((), device=dev, dtype=dtype)
            metrics = dict(critic_loss=zero, actor_loss=zero.clone(),
                           alpha=torch.exp(st.log_alpha.detach()))
        if clock:
            timings["update_ms"] = clock.lap()
        metrics["mean_reward"] = torch.stack(rews).mean()
        metrics["replay_size"] = torch.tensor(st.replay.size)
        metrics["nan_resets"] = es.nan_resets.sum()
        return st, es, metrics

    return init_fn, train_iter_fn, act_fn


def sac_params_to_numpy(state: SACState) -> Dict:
    """The JAX package's trees: {"actor": [...], "critic": {"q1": [...],
    "q2": [...]}, "target_critic": {...}, "log_alpha": ()}."""
    crit = lambda c: {q: N.mlp_to_numpy(c[q]) for q in ("q1", "q2")}
    return {"actor": N.mlp_to_numpy(state.actor),
            "critic": crit(state.critic),
            "target_critic": crit(state.target_critic),
            "log_alpha": state.log_alpha.detach().cpu().numpy().copy()}


def sac_params_from_numpy(state: SACState, params: Dict) -> SACState:
    """Copy JAX-layout `params` (as `sac_params_to_numpy` returns; a
    missing "target_critic" copies "critic") into `state`'s modules, in
    place, keeping their devices and dtypes."""
    N._copy_layers(state.actor, params["actor"])
    for name in ("critic", "target_critic"):
        tree = params.get(name, params["critic"])
        for q in ("q1", "q2"):
            N._copy_layers(getattr(state, name)[q], tree[q])
    with torch.no_grad():
        state.log_alpha.copy_(torch.as_tensor(np.array(params["log_alpha"])))
    return state
