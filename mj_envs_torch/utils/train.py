"""Training loops of the PyTorch port (`mj_envs_tpu/utils/train.py`):
the PPO trainer on state or pixel observations, the NPG/DAPG and SAC
trainers, and the PlaNet trainer.

One "episode" is one learner iteration over `num_envs` envs on the env's
device (`algos/ppo.py`, `algos/npg.py`, `algos/sac.py`); the host loop
keeps the reference cadence: evaluation every `test_interval`,
checkpoints every `checkpoint_interval`, metrics logging.  PPO resumes
from the latest checkpoint when `models_path` is set; the NPG, SAC and
PlaNet loops have no resume, as the JAX package's have none.  PlaNet
alternates gradient steps on replayed sequences with one single-env
rollout per episode (`train_planet_policy`).
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import trace
from ..algos import npg as NPG
from ..algos import ppo as PPO
from ..algos import sac as SAC
from ..envs.base import AdroitEnv
from ..envs.pixels import PixelObservationEnv
from ..parallel.distributed import env_shards, process_local_batch
from ..parallel.vector import reset_rows
from . import checkpoint as CKPT
from .eval import make_evaluate, make_pixel_evaluate

PROF = True


class ProfilerHook:
    """A `torch.profiler` trace over training episodes 2..3 (steady
    state, after episode 1's kernel builds), enabled by setting
    MJE_PROFILE_DIR; the Chrome trace goes to
    $MJE_PROFILE_DIR/trace.json.  The tracer (`mj_envs_torch.trace`) is
    on over those episodes, so the trace shows its spans (`env.step`,
    `physics.*`, `collide.*`, ...) as ranges around the device work they
    issue."""

    START_EP, STOP_EP = 2, 3

    def __init__(self):
        self.dir = os.environ.get("MJE_PROFILE_DIR", "")
        self.prof = None
        self.traced = False

    def before(self, episode: int):
        if self.dir and self.prof is None and episode == self.START_EP:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.traced = trace.enabled()
            trace.enable()
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()

    def after(self, episode: int):
        if self.prof is not None and episode >= self.STOP_EP:
            self.prof.stop()
            trace.enable(self.traced)
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(self.dir, "trace.json")
            self.prof.export_chrome_trace(path)
            self.prof = None
            print(f"profiler trace written to {path}", flush=True)


class Metrics:
    """Accumulating scalar metrics, written as CSV and, when `tb_dir` is
    given and tensorboard is installed, streamed to TensorBoard event
    files."""

    def __init__(self, tb_dir: Optional[str] = None):
        self.rows: List[Dict[str, float]] = []
        self._tb = None
        if tb_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=tb_dir)
            except Exception as e:   # tensorboard optional at runtime
                print(f"tensorboard writer unavailable: {e}")

    def append(self, **kw: float):
        self.rows.append({k: float(v) for k, v in kw.items()})
        if self._tb is not None:
            step = int(kw.get("episode", len(self.rows)))
            for k, v in kw.items():
                if k != "episode":
                    self._tb.add_scalar(k, float(v), step)

    def close(self):
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
            self._tb = None

    def save_csv(self, path: str):
        if not self.rows:
            return
        keys = sorted({k for r in self.rows for k in r})
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(",".join(keys) + "\n")
            for r in self.rows:
                f.write(",".join(str(r.get(k, "")) for k in keys) + "\n")


def ppo_config(config) -> PPO.PPOConfig:
    """The learner's PPOConfig from a `utils.config` Config."""
    return PPO.PPOConfig(
        lr=config.learning_rate,
        n_steps=getattr(config, "n_steps", 64),
        n_minibatches=getattr(config, "n_minibatches", 8),
        n_epochs=getattr(config, "n_epochs", 4),
        gamma=getattr(config, "gamma", 0.99),
        gae_lambda=getattr(config, "gae_lambda", 0.95),
        clip_eps=getattr(config, "clip_eps", 0.2),
        max_grad_norm=float(config.grad_clip_norm),
    )


def train_ppo_policy(config, env: AdroitEnv, out_dir: Optional[str] = None,
                     debug_nans: bool = False,
                     callback: Optional[Callable] = None, mesh=None):
    """PPO training to `config.max_episodes` iterations on
    `config.device_type` (the card by default; the env must be on it),
    on state observations or, with `model_type` "cnn", on 64x64 pixels
    through the CNN actor-critic.  Returns (train_state, metrics).

    Each iteration's row holds the PPO metrics, env-steps/s and the ms
    of its rollout (for pixels also of its physics, render and policy
    parts), GAE and update; `callback(episode, row)`, when
    given, is called after each iteration.  `debug_nans` raises on an
    env state that the quarantine would restart.

    With `mesh` (`parallel/distributed.make_mesh`; state observations
    only) `config.num_envs` envs run on each env shard: this rank resets
    and steps its rows of the global batch, and every rank runs the
    update on the gathered batch (`make_ppo(mesh=...)`), so the run is
    the single-process one over the global batch.  Env-steps count
    globally; rank 0 alone evaluates, writes checkpoints, metrics.csv
    and TensorBoard, and prints."""
    out_dir = out_dir or (config.log_path or "results")
    cfg = ppo_config(config)
    num_envs = config.num_envs
    model_type = getattr(config, "model_type", "mlp") or "mlp"
    lead = mesh is None or dist.get_rank() == 0
    if mesh is not None:
        if model_type == "cnn":
            raise ValueError("pixel PPO runs on one card: no mesh")
        num_envs *= env_shards(mesh)

    def eval_policy(module, obs, generator):
        return torch.clamp(module(obs)[0], -1.0, 1.0)

    if model_type == "cnn":
        # Pixel PPO (the reference's ActorCriticCnnPolicy over pixels,
        # baselines.py:120-134).
        penv = PixelObservationEnv(env)
        init_fn, train_iter_fn, _ = PPO.make_pixel_ppo(
            penv, num_envs, cfg, device=config.device_type,
            debug_nans=debug_nans)
        reset = penv.reset
        evaluate = make_pixel_evaluate(penv, eval_policy,
                                       env.MAX_EPISODE_STEPS)
    else:
        init_fn, train_iter_fn, _ = PPO.make_ppo(
            env, num_envs, cfg, device=config.device_type,
            debug_nans=debug_nans, mesh=mesh)
        reset = env.reset
        if mesh is not None:
            local, offset = process_local_batch(mesh, num_envs)
            reset = lambda n, gen: reset_rows(env, n, gen, offset, local)
        evaluate = make_evaluate(env, eval_policy, env.MAX_EPISODE_STEPS)

    train_state = init_fn(config.seed)
    env_state = reset(num_envs, train_state.reset_generator)

    # Resume (reference baselines.py:149-161).
    latest = CKPT.latest(out_dir)
    if latest and config.models_path != "":
        train_state = CKPT.restore(latest, train_state)
        if lead:
            print(f"resumed from {latest}")

    metrics = Metrics(tb_dir=out_dir if lead else None)
    prof = ProfilerHook()
    if not lead:
        prof.dir = ""
    sps_hist = []
    for episode in range(1, config.max_episodes + 1):
        prof.before(episode)
        timings: Dict[str, float] = {}
        t0 = time.perf_counter()
        train_state, env_state, m = train_iter_fn(train_state, env_state,
                                                  timings=timings)
        dt = time.perf_counter() - t0      # the update's end synchronized
        prof.after(episode)
        env_steps = cfg.n_steps * num_envs
        sps_hist.append(env_steps / dt)
        row = dict(episode=episode, steps_per_s=env_steps / dt, **timings,
                   **{k: float(v) for k, v in m.items()})
        metrics.append(**row)
        if callback is not None:
            callback(episode, row)

        if not lead:
            continue
        if PROF and (episode % 10 == 0 or episode == 1):
            print(f"ep {episode:5d} reward {row['mean_reward']:8.3f} "
                  f"| {env_steps / dt:9.0f} env-steps/s "
                  f"(median {np.median(sps_hist):9.0f})", flush=True)

        if episode % config.test_interval == 0:
            res = evaluate(train_state.module, config.seed + 2, count=10)
            metrics.append(episode=episode,
                           eval_reward=res.total_rewards.mean(),
                           eval_success=res.success_rate)
            print(f"  eval: reward {res.total_rewards.mean():8.1f} "
                  f"success {res.success_rate:5.1f}%", flush=True)

        if episode % config.checkpoint_interval == 0:
            CKPT.save(CKPT.checkpoint_path(out_dir, episode), train_state)

    if lead:
        metrics.save_csv(os.path.join(out_dir, "metrics.csv"))
    metrics.close()
    return train_state, metrics


def _train_generic(config, env: AdroitEnv, out_dir: str, make_algo,
                   eval_apply, name: str, steps_per_iter: int,
                   callback: Optional[Callable] = None):
    """The NPG / SAC host loop (`_train_generic` :198-241): one learner
    iteration per episode, eval every `test_interval`, a checkpoint every
    `checkpoint_interval`, no resume.  Each iteration's row holds the
    learner's metrics, env-steps/s and the ms of its parts.
    `eval_apply(state, obs, generator)` gives the eval actions of a
    learner state."""
    num_envs = config.num_envs
    init_fn, train_iter_fn, _ = make_algo()
    state = init_fn(config.seed)
    env_state = env.reset(num_envs, state.reset_generator)
    evaluate = make_evaluate(env, eval_apply, env.MAX_EPISODE_STEPS)

    metrics = Metrics(tb_dir=out_dir)
    prof = ProfilerHook()
    for episode in range(1, config.max_episodes + 1):
        prof.before(episode)
        timings: Dict[str, float] = {}
        t0 = time.perf_counter()
        state, env_state, m = train_iter_fn(state, env_state,
                                            timings=timings)
        dt = time.perf_counter() - t0      # the update's end synchronized
        prof.after(episode)
        row = dict(episode=episode,
                   steps_per_s=steps_per_iter * num_envs / dt, **timings,
                   **{k: float(v) for k, v in m.items()})
        metrics.append(**row)
        if callback is not None:
            callback(episode, row)
        if PROF and (episode % 10 == 0 or episode == 1):
            print(f"{name} ep {episode:5d} reward "
                  f"{row['mean_reward']:8.3f} ({dt:.2f}s/it)", flush=True)
        if episode % config.test_interval == 0:
            res = evaluate(state, config.seed + 2, count=10)
            metrics.append(episode=episode,
                           eval_reward=res.total_rewards.mean(),
                           eval_success=res.success_rate)
            print(f"  eval: reward {res.total_rewards.mean():8.1f} "
                  f"success {res.success_rate:5.1f}%", flush=True)
        if episode % config.checkpoint_interval == 0:
            CKPT.save(CKPT.checkpoint_path(out_dir, episode), state)

    metrics.save_csv(os.path.join(out_dir, "metrics.csv"))
    metrics.close()
    return state, metrics


def npg_config(config) -> NPG.NPGConfig:
    """The learner's NPGConfig from a `utils.config` Config: a field the
    Config lacks (a plain Config has no n_steps or gamma) takes the JAX
    trainer's default."""
    return NPG.NPGConfig(
        n_steps=getattr(config, "n_steps", 64),
        normalized_step_size=getattr(config, "normalized_step_size", 0.1),
        gamma=getattr(config, "gamma", 0.995),
        gae_lambda=getattr(config, "gae_lambda", 0.97))


def sac_config(config) -> SAC.SACConfig:
    """The learner's SACConfig from a `utils.config` Config.  As in the
    JAX trainer, `batch_size` is the Config's (50 unless set; 256 only
    where it is 0 or missing)."""
    return SAC.SACConfig(lr=config.learning_rate,
                         batch_size=getattr(config, "batch_size", 256) or 256)


def train_npg_policy(config, env: AdroitEnv, out_dir: Optional[str] = None,
                     demos=None, callback: Optional[Callable] = None):
    """NPG / DAPG training (`algos/npg.py`; DAPG when `demos` =
    {"obs", "actions"} is given) on `config.device_type`.  Eval actions
    are the policy mean, clipped."""
    out_dir = out_dir or (config.log_path or "results")
    cfg = npg_config(config)
    make = lambda: NPG.make_npg(env, config.num_envs, cfg, demos=demos,
                                device=config.device_type)

    def eval_apply(state, obs, generator):
        return torch.clamp(state.module(obs)[0], -1.0, 1.0)

    return _train_generic(config, env, out_dir, make, eval_apply, "npg",
                          cfg.n_steps, callback)


def train_sac_policy(config, env: AdroitEnv, out_dir: Optional[str] = None,
                     callback: Optional[Callable] = None):
    """SAC training (`algos/sac.py`) on `config.device_type`.  Eval
    actions are tanh of the actor's mean."""
    out_dir = out_dir or (config.log_path or "results")
    cfg = sac_config(config)
    make = lambda: SAC.make_sac(env, config.num_envs, cfg,
                                device=config.device_type)

    def eval_apply(state, obs, generator):
        return torch.tanh(SAC._actor_dist(state.actor, obs, env.nu, cfg)[0])

    return _train_generic(config, env, out_dir, make, eval_apply, "sac",
                          cfg.steps_per_iter, callback)


def train_planet_policy(config, env: AdroitEnv, out_dir: Optional[str] = None,
                        callback: Optional[Callable] = None):
    """PlaNet training (`train.py:287-407`, the reference's
    `train_policy`, train.py:93-176) on `config.device_type`.

    The replay is seeded with episodes of uniform random actions (from
    `np.random.default_rng(config.seed)`) until it holds
    max(batch_size, chunk_size) steps and `seed_episodes` episodes; then
    each episode takes `sample_iters` gradient steps on sampled chunks
    and one single-env exploration rollout, acting on the planned action
    plus `action_noise` x U[0, 1) (the reference's noise, not
    zero-mean).  Every rollout has max_episode_length // action_repeat
    steps, its last step terminal, and each step appends the frame the
    action was computed from.  A checkpoint {"params", "opt_state"}
    every `checkpoint_interval` episodes.  Each episode's row holds the
    losses, the rollout's reward, the ms of one batch's sampling and of
    one update, the collect ms, the plan's ms per step, the collect
    env-steps/s and the episode's env-steps/s (its rollout's steps over
    its updates and rollout); `callback(episode, row)`,
    when given, is called after each.  Returns (PlanetState, metrics)."""
    from ..algos import planet as PL
    from ..algos import replay as RP
    from ..render.raster import images_to_observation

    out_dir = out_dir or (config.log_path or "results")
    dev = PPO.check_device(env, config.device_type)
    penv = PixelObservationEnv(env)
    cfg = PL.cfg_from_config(config, env.nu)
    init_fn, update_fn, infer_step, plan = PL.make_planet(
        cfg, device=dev, dtype=env.dtype)
    state = init_fn(config.seed)
    gen = torch.Generator(device=dev).manual_seed(config.seed + 1)
    mem = RP.ExperienceReplay(
        config.experience_size, (64, 64, 3), env.nu,
        bit_depth=config.bit_depth, seed=config.seed)
    T = config.max_episode_length // config.action_repeat

    def append(pre_pixels, ps, action, last: bool):
        """The frame the action was computed from goes in with the step's
        reward; the rollout's last step is terminal (the reference's
        PlaNet env wrapper ends an episode at max_episode_length; without
        it the seed loop below would never end on the three tasks that
        never terminate)."""
        reward = float(ps.state.reward[0])
        mem.append(pre_pixels[0].cpu().numpy(), np.asarray(action),
                   reward, bool(ps.state.done[0]) or last)
        return reward

    def collect(explore_noise: float, times: Dict[str, float]):
        """One single-env rollout acting through the filter and the
        planner (`collect_experience`, train.py:179-195): its reward."""
        module = state.params
        clock = trace.Clock(dev)
        ps = penv.reset(1, gen)
        h = torch.zeros((1, cfg.belief_size), dtype=env.dtype, device=dev)
        s = torch.zeros((1, cfg.state_size), dtype=env.dtype, device=dev)
        a = torch.zeros((1, env.nu), dtype=env.dtype, device=dev)
        total_r = 0.0
        for t in range(T):
            pre = ps.pixels
            obs = images_to_observation(pre, config.bit_depth, gen)
            h, s = infer_step(module, h, s, a, obs, gen)
            a = plan(module, h, s, gen)
            times["plan_ms"] += clock.lap()
            if explore_noise > 0:
                a = torch.clamp(a + explore_noise * torch.rand(
                    a.shape, generator=gen, device=dev, dtype=a.dtype),
                    -1.0, 1.0)
            ps = penv.step(ps, a, gen)
            total_r += append(pre, ps, a[0].cpu().numpy(), t == T - 1)
            times["env_ms"] += clock.lap()
        return total_r

    rng = np.random.default_rng(config.seed)
    t_seed = time.perf_counter()
    while mem.steps < max(config.batch_size, config.chunk_size) \
            or mem.episodes < config.seed_episodes:
        ps = penv.reset(1, gen)
        for t in range(T):
            a = rng.uniform(-1, 1, env.nu).astype(np.float32)
            pre = ps.pixels
            ps = penv.step(ps, torch.as_tensor(a, device=dev)[None], gen)
            append(pre, ps, a, t == T - 1)
    if PROF:
        print(f"planet: replay seeded ({mem.steps} steps, "
              f"{time.perf_counter() - t_seed:.1f} s)", flush=True)

    metrics = Metrics(tb_dir=out_dir)
    prof = ProfilerHook()
    for episode in range(config.seed_episodes + 1, config.max_episodes + 1):
        prof.before(episode)
        clock = trace.Clock(dev)
        times = dict(sample_ms=0.0, update_ms=0.0, plan_ms=0.0, env_ms=0.0)
        for _ in range(config.sample_iters):
            batch = mem.sample(config.batch_size, config.chunk_size)
            times["sample_ms"] += clock.lap()
            m = update_fn(state, batch, gen)
            times["update_ms"] += clock.lap()
        total_r = collect(config.action_noise, times)
        collect_ms = times["plan_ms"] + times["env_ms"]
        prof.after(episode)
        n = max(config.sample_iters, 1)
        episode_ms = sum(times.values())
        row = dict(episode=episode, reward=total_r,
                   steps_per_s=T / episode_ms * 1e3,
                   sample_ms=times["sample_ms"] / n,
                   update_ms=times["update_ms"] / n,
                   collect_ms=collect_ms, plan_ms=times["plan_ms"] / T,
                   collect_steps_per_s=T / collect_ms * 1e3,
                   **{k: float(v) for k, v in m.items()})
        metrics.append(**row)
        if callback is not None:
            callback(episode, row)
        if PROF:
            print(f"planet ep {episode}: reward {total_r:.1f} obs_loss "
                  f"{row['obs_loss']:.1f} kl {row['kl_loss']:.2f}",
                  flush=True)
        if episode % config.checkpoint_interval == 0:
            CKPT.save(CKPT.checkpoint_path(out_dir, episode), state)
    metrics.save_csv(os.path.join(out_dir, "metrics.csv"))
    metrics.close()
    return state, metrics
