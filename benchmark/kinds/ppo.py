"""kind `ppo`: iterations of the port's PPO trainer (`make_ppo` /
`train_iter_fn`) with the traffic's hyperparameters, one unit one
iteration (rollout, GAE, update).  The weights, the action noise and
the minibatch permutations are the benchmark's draws from the seed;
episode phases are staggered as in `rollout`.

The check follows two iterations of the one trainer object that the
window drives:

* the warm-up iteration, from the benchmark's own weights: its physics
  on sampled rows, the policy's actions, log-probs and values on every
  row, GAE, and the update's first three Adam steps on the program's
  minibatches with the reference's own advantages (each step's loss,
  the first clipped gradient from Adam's first moment after one step,
  the parameters' change after three, each by its worst leaf);
* the window's last iteration, from the program's parameters and Adam
  state at its start: its physics on sampled rows, the policy on every
  row, and the parameters' change over the whole update (every epoch
  and minibatch) against the reference's, by the worst leaf.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..lib import check, drive, trace

F64 = torch.float64


class Capture:
    """Records what the check reads from one iteration: each rollout
    step's pre-step state, actions and merged state, the trajectory and
    GAE's outputs, the noise and permutations, the parameters and Adam's
    state before the iteration and the parameters after it, the first
    three losses, Adam's first moment after the first step and the
    parameters after the third."""

    def __init__(self, d: "Drive"):
        self.drive = d
        self.patches: Optional[trace.Patches] = None

    def begin(self) -> None:
        """Clear the last iteration's records and snapshot the state it
        starts from (called before each iteration)."""
        self.steps, self.losses, self.n_opt = [], [], 0
        self.gae = self.first_moment = self.params3 = None
        module, opt = self.drive.ts.module, self.drive.ts.optimizer
        self.params0 = _params(module)
        self.adam0 = {}
        for n, p in module.named_parameters():
            st = opt.state.get(p, {})
            if st:
                self.adam0[n] = (st["exp_avg"].detach().clone(),
                                 st["exp_avg_sq"].detach().clone(),
                                 int(st["step"]))
            else:
                self.adam0[n] = (torch.zeros_like(p), torch.zeros_like(p), 0)

    def end(self) -> None:
        d = self.drive
        self.noise, self.perms = d.noise, d.perms
        self.params_end = _params(d.ts.module)

    def install(self) -> None:
        cap = self
        self.patches = trace.Patches()

        def step_rows(orig):
            def w(env, fn, es, actions, plan, gen):
                merged, raw = orig(env, fn, es, actions, plan, gen)
                cap.steps.append((es, actions, merged))
                return merged, raw
            return w

        def gae(orig):
            def w(cfg, traj, last_value):
                advs, rets = orig(cfg, traj, last_value)
                cap.gae = (traj, last_value, advs, rets)
                return advs, rets
            return w

        def ppo_loss(orig):
            def w(*a, **k):
                out = orig(*a, **k)
                if len(cap.losses) < 3:
                    cap.losses.append(out[0].detach().clone())
                return out
            return w

        self.patches.wrap("mj_envs_torch.algos.ppo:step_rows", step_rows)
        self.patches.wrap("mj_envs_torch.algos.ppo:_gae", gae)
        self.patches.wrap("mj_envs_torch.algos.ppo:ppo_loss", ppo_loss)
        opt = self.drive.ts.optimizer
        orig_step = opt.step

        def opt_step(*a, **k):
            out = orig_step(*a, **k)
            cap.n_opt += 1
            if cap.n_opt == 1:
                cap.first_moment = {
                    n: opt.state.get(p, {}).get(
                        "exp_avg", torch.zeros_like(p)).detach().clone()
                    for n, p in cap.drive.ts.module.named_parameters()}
            if cap.n_opt == 3:
                cap.params3 = _params(cap.drive.ts.module)
            return out
        opt.step = opt_step
        self._opt = opt

    def uninstall(self) -> None:
        if self.patches is not None:
            del self._opt.step
            self.patches.undo()
            self.patches = None


def _params(module) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in module.named_parameters()}


class Drive:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 limits: dict):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.num_envs = int(traffic["num_envs"])
        self.timings: Optional[List[dict]] = None
        self.recording: Optional[Capture] = None

    def ppo_config(self):
        from mj_envs_torch.algos.ppo import PPOConfig
        t = self.traffic
        return PPOConfig(lr=t["learning_rate"], n_steps=t["n_steps"],
                         n_minibatches=t["n_minibatches"],
                         n_epochs=t["n_epochs"], gamma=t["gamma"],
                         gae_lambda=t["gae_lambda"], clip_eps=t["clip_eps"],
                         vf_coef=t["vf_coef"], ent_coef=t["ent_coef"],
                         max_grad_norm=t["grad_clip_norm"],
                         hidden=tuple(t["hidden"]))

    def setup(self) -> None:
        """Build the trainer, load the benchmark's weights and run the
        warm-up iteration, recorded for the check."""
        from mj_envs_torch import envs
        from mj_envs_torch.algos.ppo import make_ppo
        self.env = envs.make(self.config["env_id"], device=self.device)
        self.cfg = self.ppo_config()
        init_fn, self.train_iter, _ = make_ppo(self.env, self.num_envs,
                                               self.cfg, device=self.device)
        self.ts = init_fn(drive.sub_seed(self.seed, "init"))
        self.weights = drive.policy_weights(
            self.seed, self.env.OBS_DIM, self.env.nu, self.cfg.hidden,
            self.device)
        with torch.no_grad():
            self.ts.module.load_state_dict(self.weights)
        state = self.env.reset(self.num_envs, self.ts.reset_generator)
        if self.traffic.get("staggered_phase"):
            state = drive.staggered(
                state, self.config["max_episode_steps"],
                drive.generator(self.device, self.seed, "phase"))
        self.initial = self.state = state
        self.gen_noise = drive.generator(self.device, self.seed, "noise")
        self.gen_perm = drive.generator(self.device, self.seed, "perms")
        self.warmup = self.recording = Capture(self)
        self.warmup.install()
        try:
            self.unit()
        finally:
            self.warmup.uninstall()
        self.recording = None

    def inputs(self):
        T, B, nu = self.cfg.n_steps, self.num_envs, self.env.nu
        noise = torch.randn(T, B, nu, generator=self.gen_noise,
                            device=self.device)
        perms = torch.stack([
            torch.randperm(T * B, generator=self.gen_perm,
                           device=self.device)
            for _ in range(self.cfg.n_epochs)])
        return noise, perms

    def unit(self) -> int:
        self.noise, self.perms = self.inputs()
        if self.recording is not None:
            self.recording.begin()
        timings = {} if self.timings is not None else None
        self.ts, self.state, self.metrics = self.train_iter(
            self.ts, self.state, self.noise, self.perms, timings=timings)
        if timings is not None:
            self.timings.append(timings)
        if self.recording is not None:
            self.recording.end()
        return self.cfg.n_steps * self.num_envs

    def mark(self) -> None:
        """The window starts: record each iteration, keeping the last."""
        self.window_start = self.state
        self.last = self.recording = Capture(self)
        self.last.install()

    def close(self) -> None:
        if self.recording is not None:
            self.recording.uninstall()
            self.recording = None

    def failed(self) -> int:
        return drive.failures(self.window_start, self.state)


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               keep) -> float:
    """max over leaves of | |prog| - |ref| | / max(|ref|, median leaf |ref|),
    norms of each leaf, over the leaves in `keep`."""
    names = [n for n in ref if n in keep]
    rn = {n: float(ref[n].norm()) for n in names}
    med = float(np.median(list(rn.values())))
    return max(abs(float(prog[n].to(F64).norm()) - rn[n])
               / max(rn[n], med, 1e-30) for n in names)


class _Iteration:
    """What the check keeps of one recorded iteration: its trajectory
    and the policy's inputs on every row, its physics on sampled rows."""

    def __init__(self, cap: Capture, limits: dict, seed: int, tag: str):
        traj, last_value, advs, rets = cap.gae
        self.traj, self.last_value = traj, last_value
        self.advs, self.rets = advs, rets
        self.noise, self.perms = cap.noise, cap.perms
        self.params0, self.adam0 = cap.params0, cap.adam0
        self.params_end = cap.params_end
        self.final_obs = torch.stack([m.final_obs for _, _, m in cap.steps])
        self.truncated = torch.stack([m.truncated for _, _, m in cap.steps])
        self.last_obs = cap.steps[-1][2].obs
        self.phys = []
        per_step = max(1, limits["sample_envs"] // len(cap.steps))
        for t, (pre, action, post) in enumerate(cap.steps):
            rows = check.sample(seed, f"{tag}{t}", post, per_step,
                                limits["sample_restarts"])
            self.phys.append((check.rows_of(pre, rows), action[rows],
                              check.rows_of(post, rows)))

    def policy(self, dtype):
        """The reference's actions, log-probs, values, truncation
        bootstraps and last values from the iteration's starting
        parameters and noise."""
        from ..reference import policy as RP
        p = {k: v.to(dtype) for k, v in self.params0.items()}
        obs = self.traj.obs.to(dtype)
        action, logp, value = RP.act(p, obs, self.noise.to(dtype))
        boot = torch.where(self.truncated, RP.forward(
            p, self.final_obs.to(dtype))[2], torch.zeros_like(value))
        last = RP.forward(p, self.last_obs.to(dtype))[2]
        return action, logp, value, boot, last

    def physics(self, config, device, control: bool):
        """The sampled rows' (pre, actions, judged post): the program's,
        or the control's step from the same rows."""
        pres = check.cat_states([p for p, _, _ in self.phys])
        acts = torch.cat([torch.clamp(a, -1.0, 1.0)
                          for _, a, _ in self.phys])
        posts = check.cat_states([q for _, _, q in self.phys])
        if control:
            low = check.reference_env(config["env_id"], device,
                                      torch.float32)
            with check.tf32():
                posts = check.auto_reset_step(low, pres, acts, posts.var)
        return pres, acts, posts

    def batches(self, traffic, obs, action, logp, advs, rets, dtype,
                count: Optional[int] = None) -> List[tuple]:
        """The update's minibatches in its order, epoch by epoch, each
        epoch's permutation cut into `n_minibatches`; the first `count`
        of them, or all."""
        n = advs.numel()
        k = traffic["n_minibatches"]
        mb = n // k
        flat = lambda x: x.reshape((n,) + x.shape[2:]).to(dtype)
        obs, action, logp, advs, rets = map(flat, (obs, action, logp, advs,
                                                   rets))
        total = traffic["n_epochs"] * k if count is None else count
        out = []
        for i in range(total):
            sel = self.perms[i // k][(i % k) * mb:(i % k + 1) * mb]
            out.append(tuple(x[sel] for x in (obs, action, logp, advs, rets)))
        return out


class Check:
    """Keeps what the PPO check reads from the warm-up iteration and the
    window's last one, on the sampled rows only for the physics."""

    def __init__(self, d: Drive, cell, seed: int):
        lim = cell.limits
        self.config, self.traffic = cell.config, cell.traffic
        w = d.warmup
        self.warm = _Iteration(w, lim, seed, "ppo")
        # the warm-up starts from the benchmark's own weights
        self.warm.params0 = {k: v.clone() for k, v in d.weights.items()}
        self.losses = torch.stack(w.losses)
        self.first_moment, self.params3 = w.first_moment, w.params3
        self.last = _Iteration(d.last, lim, seed, "last") \
            if d.last.gae is not None else None
        rows0 = check.sample(seed, "start", d.initial, lim["sample_envs"], 0)
        self.start = check.rows_of(d.initial, rows0)

    def _update(self, it: _Iteration, batches, dtype, adam0=None):
        from ..reference import policy as RP
        t = self.traffic
        return RP.update_steps(
            {k: v.to(dtype) for k, v in it.params0.items()}, batches,
            t["learning_rate"], t["grad_clip_norm"], t["clip_eps"],
            t["vf_coef"], t["ent_coef"], adam0)

    def numbers(self, device, control: bool = False) -> Dict[str, float]:
        from ..reference import policy as RP
        t = self.traffic
        ref = check.reference_env(self.config["env_id"], device)
        start = self.start
        if control:
            start = check.start_rows(check.reference_env(
                self.config["env_id"], device, torch.float32), start)
        parts = [check.reset_numbers(ref, self.config, start)]
        its = [self.warm] + ([self.last] if self.last is not None else [])
        for it in its:
            parts.append(check.step_numbers(
                ref, self.config, *it.physics(self.config, device, control)))
        out = check.physics_summary(parts)
        f32 = torch.float32

        def judged(it: _Iteration):
            """The judged side's policy outputs and GAE on `it`: the
            program's, or the control's."""
            tr = it.traj
            if not control:
                return (tr.action, tr.log_prob, tr.value, tr.trunc_boot,
                        it.last_value, it.advs, it.rets)
            with check.tf32():
                action, logp, value, boot, last = it.policy(f32)
                advs, rets = RP.gae(tr.reward, value, tr.done, boot, last,
                                    t["gamma"], t["gae_lambda"])
            return action, logp, value, boot, last, advs, rets

        def policy_gap(it, action, logp, value, boot, last) -> float:
            r = it.policy(F64)
            return max(check._worst(check._rel(x, y)) for x, y in
                       zip((action, logp, value, boot, last), r))

        # The warm-up iteration.
        it = self.warm
        action, logp, value, boot, last, advs, rets = judged(it)
        out["policy_err"] = policy_gap(it, action, logp, value, boot, last)
        # GAE on the judged side's own trajectory.
        tr = it.traj
        g_adv, g_ret = RP.gae(tr.reward.to(F64), value.to(F64), tr.done,
                              boot.to(F64), last.to(F64), t["gamma"],
                              t["gae_lambda"])
        out["gae_err"] = max(
            check._worst((advs.to(F64) - g_adv).abs())
            / max(float(g_adv.abs().max()), 1e-30),
            check._worst((rets.to(F64) - g_ret).abs())
            / max(float(g_ret.abs().max()), 1e-30))
        # The first three Adam steps on the judged side's minibatches, the
        # reference's advantages its own GAE's (so that loss_err also
        # holds the judged side's GAE).
        if control:
            with check.tf32():
                c_batches = it.batches(t, tr.obs, action, logp, advs, rets,
                                       f32, 3)
                losses, first, p3 = self._update(it, c_batches, f32)
            losses = torch.stack(losses)
        else:
            losses, p3 = self.losses, self.params3
            first = {k: v / (1 - RP.B1) for k, v in self.first_moment.items()}
        r_losses, r_first, r_p3 = self._update(
            it, it.batches(t, tr.obs, action, logp, g_adv, g_ret, F64, 3),
            F64)
        r_losses = torch.stack(r_losses)
        out["loss_err"] = check._worst((losses.to(F64) - r_losses).abs()
                                       / r_losses.abs().clamp(min=1e-30))
        g_norms = {k: float(g.norm()) for k, g in r_first.items()}
        g_med = float(np.median(list(g_norms.values())))
        moved = {k for k, g in g_norms.items() if g >= 1e-3 * g_med}
        out["grad_err"] = _leaf_gaps(first, r_first, set(r_first))
        w64 = {k: v.to(F64) for k, v in it.params0.items()}
        out["dparam_err"] = _leaf_gaps(
            {k: p3[k].to(F64) - w64[k] for k in p3},
            {k: r_p3[k] - w64[k] for k in r_p3}, moved)

        # The window's last iteration, from the program's parameters and
        # Adam state at its start: the policy on every row, and the
        # parameters' change over the whole update.
        it = self.last
        if it is None:
            return out
        action, logp, value, boot, last, advs, rets = judged(it)
        out["policy_last_err"] = policy_gap(it, action, logp, value, boot,
                                            last)
        tr = it.traj
        if control:
            with check.tf32():
                _, _, p_end = self._update(
                    it, it.batches(t, tr.obs, action, logp, advs, rets, f32),
                    f32, _adam(it.adam0, f32))
        else:
            p_end = it.params_end
        g_adv, g_ret = RP.gae(tr.reward.to(F64), value.to(F64), tr.done,
                              boot.to(F64), last.to(F64), t["gamma"],
                              t["gae_lambda"])
        _, r_first, r_end = self._update(
            it, it.batches(t, tr.obs, action, logp, g_adv, g_ret, F64), F64,
            _adam(it.adam0, F64))
        g_norms = {k: float(g.norm()) for k, g in r_first.items()}
        g_med = float(np.median(list(g_norms.values())))
        moved = {k for k, g in g_norms.items() if g >= 1e-3 * g_med}
        w64 = {k: v.to(F64) for k, v in it.params0.items()}
        out["dparam_last_err"] = _leaf_gaps(
            {k: p_end[k].to(F64) - w64[k] for k in p_end},
            {k: r_end[k] - w64[k] for k in r_end}, moved)
        return out


def _adam(adam0, dtype):
    """Adam's state at an iteration's start, as `update_steps` takes it."""
    return ({k: m.to(dtype) for k, (m, _, _) in adam0.items()},
            {k: s.to(dtype) for k, (_, s, _) in adam0.items()},
            next(iter(adam0.values()))[2])


def _unchanged(p):
    p.wrap("torch.optim.adam:Adam.step",
           lambda orig: lambda self, *a, **k: None)


def _half_batch(p):
    def make(orig):
        def loss(cfg, module, obs, action, old_logp, adv, ret):
            h = max(1, obs.shape[0] // 2)
            return orig(cfg, module, obs[:h], action[:h], old_logp[:h],
                        adv[:h], ret[:h])
        return loss
    p.wrap("mj_envs_torch.algos.ppo:ppo_loss", make)


# The optimizer step returns its state unchanged; half of each minibatch
# left out, the loss the mean over the rest.  The env-level faults
# (`altered`, `merge`) are `lib/faults.py`'s.
FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch}
