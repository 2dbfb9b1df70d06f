"""What decides `correct`: the timed path's own outputs held against the
plain reference (`benchmark/reference/`), which rebuilds each model from
its own copy of the MJCF and computes in float64.

Contacts make float32 trajectories part from float64 ones within a few
steps, so the reference follows the program step by step from the
program's own state, stage by stage:

* physics, obs, reward and the auto-reset merge: for a sample of envs
  drawn from the seed (every env that restarted in the checked step
  first, up to `sample_restarts`), one env step from the program's
  pre-step rows and actions; a restarted env's fresh episode is rebuilt
  from its drawn randomization, which must lie in the configuration's
  ranges; the initial (reset) state is checked the same way;
* what a traffic kind adds (the trainer's arithmetic), in its module
  `kinds/<kind>.py`.

Each number is a median, a 90th percentile or the worst over what was
compared; `limits` in the cell's `workloads/<cell>.json` holds the limit
of each number judged, and the others are readings for `calibrate.py`.
The control (`control=True`) puts the reference, computed in float32
with TF32 matrix products, in the program's place.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

F64 = torch.float64


# -- states as the reference's objects ---------------------------------------

def rows_of(state, rows: torch.Tensor, dtype=None):
    """The reference's EnvState holding rows `rows` of `state` (the
    program's or the reference's), floats cast to `dtype` if given."""
    from ..reference.envs.base import EnvState, ModelVar
    from ..reference.physics.model import Data

    def take(t):
        t = t[rows]
        return t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t
    data = Data(**{f: take(getattr(state.data, f))
                   for f in Data.field_names()})
    var = ModelVar(**{f: take(t) for f, t in state.var.items()})
    return EnvState(data=data, var=var,
                    **{f: take(getattr(state, f)) for f in EnvState.LEAVES})


def cat_states(states):
    return states[0].map(lambda *xs: torch.cat(xs, dim=0), *states[1:])


def reference_env(env_id: str, device, dtype=F64):
    from ..reference import envs as RE
    return RE.make(env_id, device=device, dtype=dtype)


# -- the step ------------------------------------------------------------------

def auto_reset_step(env, pre, action, fresh_var):
    """The auto-resetting env step of `env` (a reference env) from `pre`:
    a restarted env's fresh episode is built from `fresh_var`'s rows."""
    st = env.step(pre, action)
    finite = (torch.isfinite(st.data.qpos).all(-1)
              & torch.isfinite(st.data.qvel).all(-1)
              & torch.isfinite(st.obs).all(-1) & torch.isfinite(st.reward))
    trunc = st.step_count >= env.MAX_EPISODE_STEPS
    restart = st.done | trunc | ~finite
    fresh = env.reset_from_var(fresh_var)
    sel = lambda a, b: torch.where(
        restart.view(restart.shape + (1,) * (a.dim() - 1)), a, b)
    core = fresh.map(sel, st)
    return core.replace(
        reward=torch.where(finite, st.reward, torch.zeros_like(st.reward)),
        done=restart, truncated=trunc & ~st.done & finite,
        final_obs=st.obs, goal_achieved=st.goal_achieved & finite,
        nan_resets=pre.nan_resets + (~finite).to(torch.int32),
        contact_clips=st.contact_clips)


def _rel(a, b):
    """|a - b| / (1 + |b|) elementwise, in float64."""
    a, b = a.to(F64), b.to(F64)
    return (a - b).abs() / (1.0 + b.abs())


def _worst(x: torch.Tensor) -> float:
    return float(x.max().item()) if x.numel() else 0.0


def var_flags(ref, var, config: dict) -> int:
    """Randomized fields outside the configuration's reset ranges, and
    fixed fields that differ from the reference model's, counted."""
    bad = 0
    spec = ref.spec
    for field, t in var.items():
        base = getattr(ref.model, field).to(F64).expand(t.shape)
        t = t.to(F64)
        free = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
        for body, ranges in config["reset_ranges"].get(field, {}).items():
            i = spec.name2id("body", body)
            for axis, lo, hi in ranges:
                x = t[:, i, axis]
                slack = 1e-6 * max(abs(lo), abs(hi))
                bad += int(((x < lo - slack) | (x > hi + slack)).sum())
                free[:, i, axis] = True
        off = (t - base).abs() > 1e-6 * (1.0 + base.abs())
        bad += int((off & ~free).sum())
    return bad


def _row_worst(x: torch.Tensor) -> torch.Tensor:
    """Each row's worst element (a row of one env)."""
    return x.reshape(x.shape[0], -1).max(-1).values if x.numel() \
        else x.reshape(0)


def step_numbers(ref, config: dict, pre, action, post) -> Dict:
    """Per-env readings of one checked env step: `pre` and `post` are the
    reference's EnvStates of the same envs (the program's rows, or the
    control's), `action` their actions; the reference recomputes the step
    in float64 from `pre` and `action`, and a restarted env's fresh
    episode from `post`'s drawn randomization.  `state`: an env's worst
    error in qpos or qvel over the largest change of that field in the
    step; `obs`: its worst |error| / (1 + |reference|) in the step's obs
    (the finishing obs at a restart), `obs_kin` the same over the columns
    that the configuration's `obs_contact_columns` does not list (the
    positions, angles and sites, which no contact force sets directly);
    `reward` likewise; `reset`, `reset_obs`: a restarted env's fresh
    episode against the reference's reset from its drawn randomization
    (`_fresh_rows`); `flags`: done, truncated, step_count or drawn
    randomization wrong, counted; `contacts`: envs whose count of active
    contacts differs from the reference's (not judged)."""
    P = pre.map(lambda x: x.to(F64) if x.is_floating_point() else x)
    R = ref.step(P, action.to(F64))
    finite = torch.isfinite(R.data.qpos).all(-1) & torch.isfinite(
        R.data.qvel).all(-1)
    trunc = R.step_count >= ref.MAX_EPISODE_STEPS
    restart = R.done | trunc | ~finite
    flags = int((post.done != restart).sum())
    flags += int((post.truncated != (trunc & ~R.done & finite)).sum())
    want_count = torch.where(restart, torch.zeros_like(R.step_count),
                             R.step_count)
    flags += int((post.step_count != want_count).sum())
    kept = ~restart
    state = torch.zeros(0, dtype=F64, device=P.obs.device)
    if bool(kept.any()):
        es = []
        for f in ("qpos", "qvel"):
            q, r, p = (getattr(x.data, f)[kept].to(F64) for x in (post, R, P))
            inc = (r - p).abs().max(-1).values.clamp(min=1e-12)
            es.append((q - r).abs().max(-1).values / inc)
        state = torch.maximum(*es)
    obs = torch.where(kept[:, None], _rel(post.obs, R.obs),
                      _rel(post.final_obs, R.obs))
    kin = torch.ones(obs.shape[-1], dtype=torch.bool, device=obs.device)
    kin[list(config.get("obs_contact_columns", []))] = False
    out = dict(state=state, obs=_row_worst(obs), obs_kin=_row_worst(
               obs[:, kin]), reward=_rel(post.reward, R.reward), flags=flags,
               contacts=int((post.data.ncon_active[kept]
                             != R.data.ncon_active[kept]).sum()),
               obs_col=int(obs.max(0).values.argmax()) if obs.numel()
               else -1)
    if bool(restart.any()):
        fresh = rows_of(post, restart.nonzero()[:, 0])
        out["flags"] += var_flags(ref, fresh.var, config)
        out["reset"], out["reset_obs"] = _fresh_rows(ref, fresh)
    return out


# The physics state a fresh episode starts from: the program's has to be
# the reference's rounded to the program's precision, exactly.
RESET_FIELDS = ("qpos", "qvel", "qacc_warmstart", "ctrl", "time")


def _fresh_rows(ref, fresh):
    """(state, obs) of each fresh episode against the reference's reset
    from the same drawn randomization: the largest |error| / (1 + |ref|)
    of its physics state (`RESET_FIELDS`), the reference rounded to the
    program's precision first (0 where they agree exactly), and of its
    obs."""
    F = ref.reset_from_var(type(fresh.var)(**{
        f: t.to(F64) for f, t in fresh.var.items()}))
    state = torch.zeros(fresh.obs.shape[0], dtype=F64,
                        device=fresh.obs.device)
    for f in RESET_FIELDS:
        x = getattr(fresh.data, f)
        y = getattr(F.data, f).to(x.dtype)
        gap = _rel(x, y)
        state = torch.maximum(state, _row_worst(gap.reshape(len(state), -1)))
    return state, _row_worst(_rel(fresh.obs, F.obs))


def reset_numbers(ref, config: dict, start) -> Dict:
    """The initial state (the program's reset) against the reference's
    reset from the same drawn randomization."""
    state, obs = _fresh_rows(ref, start)
    return dict(flags=var_flags(ref, start.var, config), reset=state,
                reset_obs=obs)


def _q90(x: torch.Tensor) -> float:
    return float(torch.quantile(x, 0.9).item()) if x.numel() else 0.0


def physics_summary(parts: List[dict]) -> Dict[str, float]:
    """The numbers over all compared envs: the median, the 90th
    percentile and the largest of the per-env readings (a quantile, so
    that one env whose contacts part from the reference's at the margin
    does not decide; a fault in a chunk's worth of envs still does)."""
    def cat(k):
        xs = [p[k].flatten() for p in parts if p.get(k) is not None]
        return torch.cat(xs) if xs else torch.zeros(0, dtype=F64)
    state, obs, reward = cat("state"), cat("obs"), cat("reward")
    obs_kin, reset, reset_obs = cat("obs_kin"), cat("reset"), \
        cat("reset_obs")
    return {
        "state_err.median": float(state.median().item())
        if state.numel() else 0.0,
        "state_err.q90": _q90(state),
        "state_err.max": _worst(state),
        "obs_err.q90": _q90(obs),
        "obs_err.max": _worst(obs),
        "obs_kin_err.q90": _q90(obs_kin),
        "reset_err.max": _worst(reset),
        "reset_obs_err.max": _worst(reset_obs),
        "reward_err.q90": _q90(reward),
        "reward_err.max": _worst(reward),
        "flags": float(sum(p.get("flags", 0) for p in parts)),
        "contacts_differ": float(sum(p.get("contacts", 0) for p in parts)),
        "obs_worst_column": float(max(p.get("obs_col", -1) for p in parts)),
    }


# -- sampling ------------------------------------------------------------------

def sample(seed: int, name: str, post, k: int, k_restart: int
           ) -> torch.Tensor:
    """Rows to check: up to k_restart of the envs that restarted, then
    others, k in all, drawn from the seed."""
    from .drive import sub_seed
    rng = np.random.default_rng(sub_seed(seed, name))
    done = post.done.detach().cpu().numpy()
    restarted = np.flatnonzero(done)
    others = np.flatnonzero(~done)
    a = rng.permutation(restarted)[:k_restart]
    b = rng.permutation(others)[:max(0, k - len(a))]
    rows = np.sort(np.concatenate([a, b]).astype(np.int64))
    return torch.as_tensor(rows, device=post.done.device)


# -- the control's precision ---------------------------------------------------

@contextlib.contextmanager
def tf32():
    """float32 matrix products in TF32 on the card (the control)."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def start_rows(ref_low, start):
    """The control's start: the reference's reset in float32 with TF32
    matrix products from the program's drawn randomization."""
    with tf32():
        return ref_low.reset_from_var(type(start.var)(**{
            f: t.to(torch.float32) for f, t in start.var.items()}))


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}) over the numbers that have
    a limit; a number that is not finite fails."""
    checked, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and v <= limit
        ok = ok and good
        checked[name] = {"value": v, "limit": limit}
    return ok, checked
