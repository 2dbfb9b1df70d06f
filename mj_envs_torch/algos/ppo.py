"""PPO of the PyTorch port (`mj_envs_tpu/algos/ppo.py`): the
state-vector learner (`make_ppo`) and the pixel learner on the CNN
actor-critic (`make_pixel_ppo`).

One iteration rolls `n_steps` auto-reset env steps of `num_envs` envs
(stepped in chunks of `step_chunk`, the port's `parallel/vector.py`),
computes GAE and runs `n_epochs` x `n_minibatches` clipped-surrogate
updates.  Where the JAX package jits one function, this is a host loop
of batched torch ops; the physics substeps inside each env step launch
the port's CUDA kernels.

Randomness is explicit: the action noise and the per-epoch permutations
come from `TrainState.generator`, the auto-resets from
`TrainState.reset_generator`.  `train_iter_fn` takes an optional `noise`
(T, B, nu) and `perms` (n_epochs, T*B) in their place, so a test can
feed the JAX package's draws.

Over a mesh (`make_ppo(..., mesh=...)`, the semantics the JAX dry run
gets from XLA with replicated params and a global batch): each rank rolls
out its own rows of the env batch (`parallel/vector.py`), its action
noise the rows of the global draw, so that its draws are the
single-process ones; GAE runs on its rows; the trajectory, advantages
and returns are gathered over the mesh's "env" axis in row order, and
every rank runs the same update on the global batch with the same
generator, so the params stay identical with no gradient all-reduce.
The gathers and the all-reduce of `nan_resets` are the tracer's span
`ppo.gather`, and the bytes of the other shards' rows that they bring
to this rank its counter `ppo.gather_bytes`; timed iterations reduce the rollout's ms
over the env shards first (`rollout_ms_max`, `rollout_ms_min`), which
waits for the slowest shard (`wait_ms`), and then lap the gathers
alone (`gather_ms`).

The optimizer is the JAX package's `optax.chain(clip_by_global_norm,
adam)`: the clip is written out (optax scales by max_norm / g_norm only
when g_norm >= max_norm, where `clip_grad_norm_` always multiplies by
max_norm / (g_norm + 1e-6)), then `torch.optim.Adam` (b1 0.9, b2 0.999,
eps 1e-8), which computes optax's update in exact arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import networks as N
from .. import trace
from ..envs.base import AdroitEnv, EnvState
from ..parallel.distributed import (all_gather_rows, all_reduce_env,
                                     env_shards, max_min_env,
                                     process_local_batch)
from ..parallel.vector import shard_plan, step_rows
from ..trace import Clock


class PPOConfig(NamedTuple):
    lr: float = 3e-4
    n_steps: int = 64            # rollout length per iteration
    n_minibatches: int = 8
    n_epochs: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5
    hidden: Tuple[int, ...] = (64, 64)
    # Envs per chunk of the batched step (the Newton loop runs until its
    # slowest env converges; chunks exit on their own).  0 disables.
    step_chunk: int = 512
    # Envs per render chunk of the pixel PPO.
    pixel_chunk: int = 256


@dataclasses.dataclass
class TrainState:
    module: N.ActorCritic
    optimizer: torch.optim.Optimizer
    generator: torch.Generator         # action noise, permutations
    reset_generator: torch.Generator   # the env's auto-resets


class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    trunc_boot: torch.Tensor   # V(final_obs) at pure truncations, else 0


def require_device(device) -> torch.device:
    """`device` as a torch.device; raises where it is the card and there
    is none (no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's learners run on the card by "
            "default; pass device='cpu' (and an env made on the CPU) to "
            "run the plain CPU path")
    return device


def check_device(env: AdroitEnv, device) -> torch.device:
    """The device a learner runs on: the env's, which must be `device`
    (the card unless the caller asks for the CPU)."""
    device = require_device(device)
    if env.device.type != device.type:
        raise ValueError(f"the env is on {env.device}, the learner was "
                         f"asked for {device}")
    return env.device


def make_optimizer(module: N.ActorCritic, cfg: PPOConfig):
    """Adam over the module's params; not the multi-tensor (foreach)
    Adam when some of them are DTensors (`dryrun.py`'s tensor-parallel
    layers), since it cannot mix them with plain tensors."""
    sharded = any(_is_dtensor(p) for p in module.parameters())
    return torch.optim.Adam(module.parameters(), lr=cfg.lr,
                            betas=(0.9, 0.999), eps=1e-8,
                            foreach=False if sharded else None)


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the grads of `params`, in place:
    g / g_norm * max_norm when g_norm >= max_norm, else unchanged.
    Returns g_norm.  A sharded (DTensor) grad counts with its whole
    tensor and is scaled shard by shard."""
    grads = [p.grad for p in params if p.grad is not None]
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in map(_whole, grads)))
    keep = g_norm < max_norm
    for g in map(_shard, grads):
        g.copy_(torch.where(keep, g, (g / g_norm) * max_norm))
    return g_norm


def _is_dtensor(t: torch.Tensor) -> bool:
    return hasattr(t, "full_tensor")


def _whole(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if _is_dtensor(t) else t


def _shard(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if _is_dtensor(t) else t


def make_ppo(env: AdroitEnv, num_envs: int, cfg: PPOConfig = PPOConfig(),
             device="cuda", debug_nans: bool = False, mesh=None):
    """Build (init_fn, train_iter_fn, act_fn) for `env` on `device` (the
    card unless the caller asks for the CPU; the env must be on it).
    With `debug_nans` a rollout step raises FloatingPointError where the
    quarantine would restart a non-finite env.  With `mesh`
    (`parallel/distributed.make_mesh`) `num_envs` is the global batch
    and the env states are this rank's rows of it
    (`VectorEnv(env, num_envs, mesh)`; module docstring).

    init_fn(seed) -> TrainState.  train_iter_fn(train_state, env_state,
    noise=None, perms=None) -> (train_state, env_state, metrics): one
    PPO iteration (rollout + GAE + update), the module and optimizer
    updated in place; `noise` is the global (T, num_envs, nu) draw.
    act_fn is `act`."""
    dev = check_device(env, device)

    def init_fn(seed: int) -> TrainState:
        gen = torch.Generator(device=dev).manual_seed(seed)
        module = N.ActorCritic(env.OBS_DIM, env.nu, cfg.hidden,
                               generator=gen, device=dev, dtype=env.dtype)
        return TrainState(module=module,
                          optimizer=make_optimizer(module, cfg),
                          generator=gen,
                          reset_generator=env.generator(seed + 1))

    return init_fn, _make_train_iter(
        cfg, dev, make_rollout(env, cfg, debug_nans, mesh, num_envs),
        lambda es: es.obs, lambda es: es, mesh), act


def _make_train_iter(cfg: PPOConfig, dev, rollout, obs_of, env_state_of,
                     mesh=None):
    """train_iter_fn(train_state, state, noise=None, perms=None,
    timings=None) -> (train_state, state, metrics): rollout, GAE from
    the value of obs_of(last state), the update (on the trajectory
    gathered over the mesh's env axis, with a mesh).  `timings`, when
    given, receives the ms of the rollout, GAE, the gather (with a mesh)
    and update (synchronizing the card between them) and whatever parts
    of the rollout rollout(train_state, state, noise, timings) times
    itself; with a mesh also the rollout's ms over the env shards
    (`rollout_ms_max`, `rollout_ms_min`: one more all-reduce, before
    the gather) and the ms until every shard is there (`wait_ms`)."""
    update = _make_update(cfg)

    def train_iter_fn(ts: TrainState, state, noise=None, perms=None,
                      timings: Optional[Dict] = None):
        clock = Clock(dev) if timings is not None else None
        state, traj = rollout(ts, state, noise, timings)
        if clock:
            timings["rollout_ms"] = clock.lap()
        with torch.no_grad():
            last_value = ts.module(obs_of(state))[2]
        advs, rets = _gae(cfg, traj, last_value)
        nan_resets = env_state_of(state).nan_resets.sum()
        if clock:
            timings["gae_ms"] = clock.lap()
        if mesh is not None:
            if clock:
                # every shard here: the wait for the slowest, lapped
                # apart so that the gather's lap is the transfer alone
                timings["rollout_ms_max"], timings["rollout_ms_min"] = \
                    max_min_env(mesh, timings["rollout_ms"], dev)
                timings["wait_ms"] = clock.lap()
            traj, advs, rets, nan_resets = _gather(mesh, traj, advs, rets,
                                                   nan_resets)
            if clock:
                timings["gather_ms"] = clock.lap()
        metrics = update(ts, traj, advs, rets, perms)
        metrics["mean_reward"] = traj.reward.mean()
        metrics["mean_episode_done"] = traj.done.to(traj.reward.dtype).mean()
        metrics["nan_resets"] = nan_resets
        if clock:
            timings["update_ms"] = clock.lap()
        return ts, state, metrics

    return train_iter_fn


def _gather(mesh, traj: Transition, advs, rets, nan_resets):
    """Every env shard's trajectory, advantages and returns joined in
    row order, and nan_resets summed over the shards (the span
    `ppo.gather`; the counter `ppo.gather_bytes` adds the bytes of the
    other shards' rows that reach this rank, each shard's the size of
    this rank's)."""
    local = (*traj, advs, rets, nan_resets)
    with trace.span("ppo.gather"):
        traj = Transition(*(all_gather_rows(mesh, x, dim=1) for x in traj))
        advs, rets = (all_gather_rows(mesh, x, dim=1) for x in (advs, rets))
        nan_resets = all_reduce_env(mesh, nan_resets)
    trace.count("ppo.gather_bytes", (env_shards(mesh) - 1)
                * sum(x.nbytes for x in local))
    return traj, advs, rets, nan_resets


def act(module, obs, generator, noise=None):
    """-> (action, log_prob, value): a Gaussian draw around the actor's
    mean (`noise` in place of the generator's normals when given)."""
    mean, log_std, value = module(obs)
    action = N.gaussian_sample(mean, log_std, generator, noise)
    return action, N.gaussian_log_prob(mean, log_std, action), value


def make_rollout(env: AdroitEnv, cfg: PPOConfig, debug_nans: bool = False,
                 mesh=None, num_envs: Optional[int] = None):
    """rollout(train_state, env_state, noise=None, timings=None) ->
    (env_state, trajectory): `cfg.n_steps` auto-reset steps
    (`ppo.py:86-106`).  The sampled action, unclipped, and its log-prob
    go into the trajectory; the env gets it clipped to [-1, 1].  The
    rollout times no parts of its own (`timings` is left as it is).
    With `mesh`, the rollout of this rank's rows of `num_envs`."""
    loop = _rollout_loop(
        env, cfg, debug_nans, observe=lambda merged: merged.obs,
        finishing_obs=lambda raw, merged: merged.final_obs,
        stored=lambda obs: obs, mesh=mesh, num_envs=num_envs)

    def rollout(ts: TrainState, env_state: EnvState, noise=None,
                timings: Optional[Dict] = None):
        es, _, traj = loop(ts, env_state, env_state.obs, noise)
        return es, traj

    return rollout


def _rollout_loop(env: AdroitEnv, cfg: PPOConfig, debug_nans: bool,
                  observe, finishing_obs, stored, mesh=None,
                  num_envs: Optional[int] = None):
    """The rollout of both learners: loop(train_state, env_state, obs,
    noise=None, timings=None) -> (env_state, obs, trajectory).  Each step
    acts on `obs`, steps the envs in chunks of `cfg.step_chunk`, and
    takes the next policy input from observe(merged state).  A
    truncation's bootstrap value is that of finishing_obs(raw, merged),
    computed only when some env truncated.  The trajectory holds
    stored(obs).  `timings`, when given, receives the ms of the policy,
    the physics and the observation (`render_ms`).

    The env state holds this rank's rows of the global batch: all of it
    without a mesh, its shard's rows of `num_envs` with one.  Each step's
    noise is the global (batch, nu) draw (or noise[t]) sliced to them,
    and the chunks step as `VectorEnv` steps them."""
    def loop(ts: TrainState, es: EnvState, obs, noise=None,
             timings: Optional[Dict] = None):
        parts = dict(physics_ms=0.0, render_ms=0.0, policy_ms=0.0)
        clock = Clock(env.device) if timings is not None else None

        def lap(part):
            if clock:
                parts[part] += clock.lap()

        n, k, lo = es.batch, es.batch, 0     # global batch, rows, offset
        if mesh is not None:
            n = num_envs
            k, lo = process_local_batch(mesh, num_envs)
        rows, plan = slice(lo, lo + k), shard_plan(n, cfg.step_chunk, k, lo)
        dtype = next(ts.module.parameters()).dtype
        out = []
        with torch.no_grad():
            for t in range(cfg.n_steps):
                eps = (noise[t] if noise is not None else torch.randn(
                    (n, env.nu), generator=ts.generator, device=env.device,
                    dtype=dtype))[rows]
                action, logp, value = act(ts.module, obs, ts.generator, eps)
                lap("policy_ms")
                merged, raw = step_rows(
                    env, env._step_auto_reset_pair, es,
                    torch.clamp(action, -1.0, 1.0), plan, ts.reset_generator)
                if debug_nans:
                    _raise_on_quarantine(t, es, merged)
                lap("physics_ms")
                # the next policy input: a fresh episode's at a reset
                nxt = observe(merged)
                trunc_boot = torch.zeros_like(value)
                if bool(merged.truncated.any()):
                    final = finishing_obs(raw, merged)
                    lap("render_ms")
                    trunc_boot = torch.where(merged.truncated,
                                             ts.module(final)[2], trunc_boot)
                    lap("policy_ms")
                else:
                    lap("render_ms")
                out.append(Transition(
                    obs=stored(obs), action=action, log_prob=logp,
                    value=value, reward=merged.reward, done=merged.done,
                    trunc_boot=trunc_boot))
                es, obs = merged, nxt
        if timings is not None:
            timings.update(parts)
        return es, obs, Transition(*(torch.stack(xs) for xs in zip(*out)))

    return loop


def make_pixel_ppo(penv, num_envs: int, cfg: PPOConfig = PPOConfig(),
                   device="cuda", debug_nans: bool = False):
    """PPO on 64x64 pixel observations with the CNN actor-critic
    (`ppo.py:207-281`, the reference's `model_type == "cnn"` family):
    (init_fn, train_iter_fn, act_fn) as `make_ppo`, over the
    `PixelEnvState`s of `penv` (an `envs.pixels.PixelObservationEnv`).
    `train_iter_fn(..., timings=d)` fills d with the ms of the rollout
    and of its physics, render and policy parts, of GAE and of the
    update."""
    env = penv.env
    dev = check_device(env, device)

    def init_fn(seed: int) -> TrainState:
        gen = torch.Generator(device=dev).manual_seed(seed)
        module = N.CnnActorCritic(env.nu, penv.height, generator=gen,
                                  device=dev, dtype=env.dtype)
        return TrainState(module=module,
                          optimizer=make_optimizer(module, cfg),
                          generator=gen,
                          reset_generator=env.generator(seed + 1))

    return init_fn, _make_train_iter(
        cfg, dev, make_pixel_rollout(penv, cfg, debug_nans),
        lambda ps: ps.pixels, lambda ps: ps.state), act


def make_pixel_rollout(penv, cfg: PPOConfig, debug_nans: bool = False):
    """rollout(train_state, pixel_state, noise=None, timings=None) ->
    (pixel_state, trajectory): `cfg.n_steps` auto-reset steps of the
    pixel envs (`ppo.py:243-266`), rendering in chunks of
    `cfg.pixel_chunk` envs.  Each frame goes into the trajectory as
    round(pixels) in uint8 (round half to even), the frames the update
    recomputes the policy on.  At a truncation the finishing frame is
    rendered from the raw post-step state, only when some env
    truncated."""
    from ..envs.pixels import PixelEnvState
    loop = _rollout_loop(
        penv.env, cfg, debug_nans,
        observe=lambda merged: penv._render(merged, cfg.pixel_chunk),
        finishing_obs=lambda raw, merged: penv._render(raw, cfg.pixel_chunk),
        stored=lambda pixels: torch.round(pixels).to(torch.uint8))

    def rollout(ts: TrainState, ps: PixelEnvState, noise=None,
                timings: Optional[Dict] = None):
        state, pixels, traj = loop(ts, ps.state, ps.pixels, noise, timings)
        return PixelEnvState(state=state, pixels=pixels), traj

    return rollout


def _raise_on_quarantine(t, before: EnvState, after: EnvState):
    bad = (after.nan_resets > before.nan_resets).nonzero().flatten()
    if bad.numel():
        raise FloatingPointError(
            f"rollout step {t}: non-finite env state in envs "
            f"{bad.tolist()[:16]} (quarantined)")


def _gae(cfg: PPOConfig, traj: Transition, last_value: torch.Tensor):
    """Generalized advantage estimation over a (T, B) trajectory:
    (advantages, returns)."""
    T = traj.reward.shape[0]
    advs = torch.empty_like(traj.value)
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    for t in range(T - 1, -1, -1):
        nonterm = 1.0 - traj.done[t].to(traj.value.dtype)
        # boundary value: 0 at termination/quarantine, V(final_obs) at
        # pure truncation, V(next obs) mid-episode
        boot = v_next * nonterm + traj.trunc_boot[t]
        delta = traj.reward[t] + cfg.gamma * boot - traj.value[t]
        adv_next = delta + cfg.gamma * cfg.gae_lambda * nonterm * adv_next
        advs[t] = adv_next
        v_next = traj.value[t]
    return advs, advs + traj.value


def ppo_loss(cfg: PPOConfig, module, obs, action, old_logp, adv, ret):
    """(total loss, metrics) of one minibatch, `_make_update.loss_fn`."""
    mean, log_std, value = module(obs)
    logp = N.gaussian_log_prob(mean, log_std, action)
    ratio = torch.exp(logp - old_logp)
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg1 = ratio * adv_n
    pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n
    pg_loss = -torch.mean(torch.minimum(pg1, pg2))
    v_loss = 0.5 * torch.mean((value - ret) ** 2)
    ent = torch.mean(N.gaussian_entropy(log_std))
    total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
    with torch.no_grad():
        clip_frac = torch.mean(
            ((ratio - 1.0).abs() > cfg.clip_eps).to(torch.float32))
        approx_kl = torch.mean(old_logp - logp)
    return total, dict(pg_loss=pg_loss.detach(), v_loss=v_loss.detach(),
                       entropy=ent.detach(), clip_fraction=clip_frac,
                       approx_kl=approx_kl)


def _make_update(cfg: PPOConfig):
    """The minibatch-epoch update: update(train_state, traj, advs, rets,
    perms=None) -> metrics averaged over epochs x minibatches; the
    module and optimizer are updated in place.  An epoch
    takes a permutation of T*B (drawn from the train state's generator
    unless `perms` gives it) and `n_minibatches` slices of
    mb = T*B // n_minibatches of it; leftover samples are dropped."""

    def update(ts: TrainState, traj: Transition, advs, rets, perms=None):
        T, B = traj.reward.shape
        n = T * B
        flat = Transition(*(x.reshape((n,) + x.shape[2:]) for x in traj))
        advs, rets = advs.reshape(n), rets.reshape(n)
        mb = n // cfg.n_minibatches
        params = list(ts.module.parameters())
        dev = advs.device
        per_mb: Dict[str, list] = {}
        for epoch in range(cfg.n_epochs):
            perm = (perms[epoch].to(dev) if perms is not None else
                    torch.randperm(n, generator=ts.generator, device=dev))
            for i in range(cfg.n_minibatches):
                sel = perm[i * mb:(i + 1) * mb]
                ts.optimizer.zero_grad(set_to_none=False)
                loss, m = ppo_loss(cfg, ts.module, flat.obs[sel],
                                   flat.action[sel], flat.log_prob[sel],
                                   advs[sel], rets[sel])
                loss.backward()
                with torch.no_grad():
                    clip_by_global_norm_(params, cfg.max_grad_norm)
                ts.optimizer.step()
                for k, v in m.items():
                    per_mb.setdefault(k, []).append(v)
        # Each metric averaged in its own dtype (clip_fraction is
        # float32 in both packages).
        return {k: torch.stack(v).mean() for k, v in per_mb.items()}

    return update
