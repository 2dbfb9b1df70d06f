"""Task-environment base of the PyTorch port (`mj_envs_tpu/envs/base.py`).

Batch-first: an `EnvState` holds B envs, every field with a leading env
axis.  `reset(num_envs, generator)` and `step(state, action)` are plain
functions of tensors; resets draw from an explicit `torch.Generator` in
place of the JAX package's per-env PRNG keys.

* Per-env model randomization (hammer's board height) is a small
  `ModelVar` of (B, ...) fields carried in the state and substituted
  into the shared, unbatched `Model` at the top of `step`.
* The reference's constructor-time actuator overwrite (wrist gain/bias
  10/-10, finger 1/-1) is applied once at build time.
* Actions in [-1, 1]^nu are de-normalized with the ctrlrange midpoint
  and half-range.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..mjcf import builder as MB, task_xml_path
from ..physics import pipeline
from ..physics.model import Data, Model, make_data


def _select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """where(mask, a, b) with the (B,) mask broadcast over trailing axes."""
    return torch.where(mask.view(mask.shape + (1,) * (a.dim() - 1)), a, b)


@dataclasses.dataclass
class ModelVar:
    """Per-env randomized model fields, (B, ...) each; only the fields a
    task randomizes are carried, the rest stay None."""

    body_pos: Optional[torch.Tensor] = None     # (B, nbody, 3)
    body_quat: Optional[torch.Tensor] = None    # (B, nbody, 4)
    body_mass: Optional[torch.Tensor] = None    # (B, nbody)
    site_pos: Optional[torch.Tensor] = None     # (B, nsite, 3)
    geom_pos: Optional[torch.Tensor] = None     # (B, ngeom, 3)
    geom_size: Optional[torch.Tensor] = None    # (B, ngeom, 3)
    geom_rgba: Optional[torch.Tensor] = None    # (B, ngeom, 4)

    FIELDS = ("body_pos", "body_quat", "body_mass", "site_pos",
              "geom_pos", "geom_size", "geom_rgba")

    def items(self):
        return [(f, getattr(self, f)) for f in self.FIELDS
                if getattr(self, f) is not None]


@dataclasses.dataclass
class EnvState:
    """B envs: physics Data + model variation + task bookkeeping."""

    data: Data
    var: ModelVar
    obs: torch.Tensor            # (B, obs_dim)
    reward: torch.Tensor         # (B,)
    done: torch.Tensor           # (B,) bool — episode boundary under
                                 # step_auto_reset (termination, truncation
                                 # or quarantine); task termination only
                                 # under plain step
    goal_achieved: torch.Tensor  # (B,) bool
    step_count: torch.Tensor     # (B,) int32
    nan_resets: torch.Tensor     # (B,) int32 — quarantined non-finite states
    truncated: torch.Tensor      # (B,) bool — boundary was the episode cap
    final_obs: torch.Tensor      # (B, obs_dim) the finishing step's obs
    contact_clips: torch.Tensor  # (B,) int32 — env steps in which compaction
                                 # dropped contacts beyond the ncmax slots

    LEAVES = ("obs", "reward", "done", "goal_achieved", "step_count",
              "nan_resets", "truncated", "final_obs", "contact_clips")

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_numpy(cls, data: Dict[str, np.ndarray],
                   var: Dict[str, np.ndarray], device="cuda",
                   dtype=torch.float32, **leaves: np.ndarray) -> "EnvState":
        """EnvState from numpy arrays, e.g. a JAX EnvState's `data` and
        `var` leaves plus its top-level leaves (its PRNG `key` has no
        counterpart here and is not passed)."""
        d = Data.from_numpy(data, device=device, dtype=dtype)
        v = ModelVar(**{k: torch.as_tensor(np.asarray(a).copy(),
                                           device=device).to(dtype)
                        for k, a in var.items() if a is not None})
        kw = {}
        for name in cls.LEAVES:
            t = torch.as_tensor(np.asarray(leaves[name]).copy(),
                                device=device)
            kw[name] = t.to(dtype) if t.is_floating_point() else t
        return cls(data=d, var=v, **kw)

    def map(self, fn, *others: "EnvState") -> "EnvState":
        """Apply fn leafwise over this state and `others`."""
        data = Data(**{f: fn(getattr(self.data, f),
                             *(getattr(o.data, f) for o in others))
                       for f in Data.field_names()})
        var = ModelVar(**{f: fn(t, *(getattr(o.var, f) for o in others))
                          for f, t in self.var.items()})
        kw = {f: fn(getattr(self, f), *(getattr(o, f) for o in others))
              for f in self.LEAVES}
        return EnvState(data=data, var=var, **kw)

    @property
    def batch(self) -> int:
        return self.obs.shape[0]


def _apply_var(model: Model, var: ModelVar) -> Model:
    """Substitute the carried per-env fields into the shared Model."""
    repl = dict(var.items())
    return model.replace(**repl) if repl else model


class AdroitEnv:
    """Base class; subclasses implement `_obs`, `_reward_done`,
    `_reset_var` and `_resolve_ids`."""

    TASK: str = ""
    FRAME_SKIP: int = 5
    MAX_EPISODE_STEPS: int = 200
    OBS_DIM: int = 0
    SUCCESS_STEPS: int = 25

    def __init__(self, variation_type: Optional[str] = None,
                 dtype=torch.float32, device="cuda",
                 xml_path: Optional[str] = None):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                "pass device='cpu' to run the plain CPU path")
        if dtype not in (torch.float32, torch.float64):
            raise NotImplementedError(
                "the port runs float32 (the card's kernel path) and float64 "
                f"(the oracle-parity path) only; got {dtype}")
        self.variation_type = variation_type
        self.dtype = dtype
        self.device = device
        model = MB.build_from_xml(xml_path or task_xml_path(self.TASK),
                                  dtype=dtype, device=device)
        self.model = self._override_actuators(model)
        s = self.model.spec
        self.spec = s
        self.nu, self.nq, self.nv = s.nu, s.nq, s.nv
        self.ncmax = pipeline.ncmax(s)
        cr = self.model.act_ctrlrange
        self.act_mid = cr.mean(dim=1)
        self.act_rng = 0.5 * (cr[:, 1] - cr[:, 0])
        self._resolve_ids()

    # -- construction helpers -------------------------------------------------

    def _override_actuators(self, model: Model) -> Model:
        """Reference ctor actuator sensitivity overwrite (wrist gain
        [10,0,0] / bias [0,-10,0], fingers [1,0,0] / [0,-1,0])."""
        a = model.spec.names["actuator"]
        gain = model.act_gainprm.clone()
        bias = model.act_biasprm.clone()
        w0, w1 = a["A_WRJ1"], a["A_WRJ0"]
        f0, f1 = a["A_FFJ3"], a["A_THJ0"]
        for (lo, hi), g, b in (((w0, w1), 10.0, -10.0), ((f0, f1), 1.0, -1.0)):
            gain[lo:hi + 1, :3] = torch.tensor([g, 0.0, 0.0], dtype=gain.dtype,
                                               device=gain.device)
            bias[lo:hi + 1, :3] = torch.tensor([0.0, b, 0.0], dtype=bias.dtype,
                                               device=bias.device)
        return model.replace(act_gainprm=gain, act_biasprm=bias)

    def _resolve_ids(self):
        raise NotImplementedError

    VAR_FIELDS: Tuple[str, ...] = ("body_pos",)

    def var_fields(self) -> Tuple[str, ...]:
        return self.VAR_FIELDS

    def base_var(self, num_envs: int) -> ModelVar:
        m = self.model
        return ModelVar(**{f: getattr(m, f).expand(
            (num_envs,) + getattr(m, f).shape).clone()
            for f in self.var_fields()})

    def generator(self, seed: int) -> torch.Generator:
        """A reset generator on this env's device."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def _uniform(self, gen, n, lo, hi) -> torch.Tensor:
        u = torch.rand(n, generator=gen, device=self.device, dtype=self.dtype)
        return lo + (hi - lo) * u

    # -- task hooks -----------------------------------------------------------

    def _reset_var(self, var: ModelVar, gen: torch.Generator) -> ModelVar:
        raise NotImplementedError

    def _obs(self, model: Model, d: Data) -> torch.Tensor:
        raise NotImplementedError

    def _reward_done(self, model: Model, d: Data):
        """-> (reward, done, goal_achieved), each (B,)."""
        raise NotImplementedError

    # -- core API -------------------------------------------------------------

    def reset(self, num_envs: int, generator: torch.Generator) -> EnvState:
        """Fresh episodes: qpos0/qvel0, task randomization, light forward
        pass (kinematic caches + jointpos/actuatorfrc sensors)."""
        return self.reset_from_var(
            self._reset_var(self.base_var(num_envs), generator))

    def skip_reset_draws(self, num_envs: int,
                         generator: torch.Generator) -> None:
        """Advance `generator` past the draws of reset(num_envs) without
        resetting (a rank skipping another rank's rows)."""
        self._reset_var(self.base_var(num_envs), generator)

    def reset_from_var(self, var: ModelVar) -> EnvState:
        """Fresh episodes of the envs whose randomized fields are `var`."""
        num_envs = next(t for _, t in var.items()).shape[0]
        model = _apply_var(self.model, var)
        d = pipeline.forward_light(model, make_data(model, num_envs,
                                                    self.dtype))
        obs = self._obs(model, d)
        dev = self.device
        zb = torch.zeros(num_envs, dtype=torch.bool, device=dev)
        zi = torch.zeros(num_envs, dtype=torch.int32, device=dev)
        return EnvState(
            data=d, var=var, obs=obs,
            reward=torch.zeros(num_envs, dtype=self.dtype, device=dev),
            done=zb, goal_achieved=zb.clone(), step_count=zi,
            nan_resets=zi.clone(), truncated=zb.clone(), final_obs=obs,
            contact_clips=zi.clone())

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        """One env step: clip/de-normalize, FRAME_SKIP physics substeps,
        obs/reward/termination."""
        model = _apply_var(self.model, state.var)
        a = torch.clamp(action.to(self.dtype), -1.0, 1.0)
        ctrl = self.act_mid + a * self.act_rng
        d = state.data
        clipped = torch.zeros_like(state.done)
        for _ in range(self.FRAME_SKIP):
            d = pipeline.step(model, d, ctrl)
            clipped = clipped | (d.ncon_active > self.ncmax)
        obs = self._obs(model, d)
        reward, done, goal = self._reward_done(model, d)
        return state.replace(
            data=d, obs=obs, reward=reward.to(self.dtype), done=done,
            goal_achieved=goal, step_count=state.step_count + 1,
            truncated=torch.zeros_like(done), final_obs=obs,
            contact_clips=state.contact_clips + clipped.to(torch.int32))

    def step_auto_reset(self, state: EnvState, action: torch.Tensor,
                        generator: torch.Generator) -> EnvState:
        """step + auto-reset on termination, the episode cap, or a
        non-finite state (quarantine).

        At a boundary the returned state is the fresh episode including
        its first obs; reward/done/goal_achieved/final_obs come from the
        finishing step, the poisoned reward of a quarantined env is
        zeroed, and `nan_resets` counts quarantines.  `truncated` marks a
        cap hit without task termination (learners bootstrap
        V(final_obs) there)."""
        return self._step_auto_reset_pair(state, action, generator)[0]

    def _step_auto_reset_pair(self, state: EnvState, action: torch.Tensor,
                              generator: torch.Generator):
        """step_auto_reset that also returns the raw post-step state."""
        st = self.step(state, action)
        finite = (torch.isfinite(st.data.qpos).all(-1)
                  & torch.isfinite(st.data.qvel).all(-1)
                  & torch.isfinite(st.obs).all(-1)
                  & torch.isfinite(st.reward))
        trunc = st.step_count >= self.MAX_EPISODE_STEPS
        restart = st.done | trunc | ~finite
        fresh = self.reset(st.batch, generator)
        new_core = fresh.map(lambda a, b: _select(restart, a, b), st)
        merged = new_core.replace(
            reward=torch.where(finite, st.reward, torch.zeros_like(st.reward)),
            done=restart,
            truncated=trunc & ~st.done & finite,
            final_obs=st.obs,
            goal_achieved=st.goal_achieved & finite,
            nan_resets=state.nan_resets + (~finite).to(torch.int32),
            contact_clips=st.contact_clips)
        return merged, st

    # -- parity/debug API (get_env_state/set_env_state analogue) --------------

    def get_env_state(self, state: EnvState) -> Dict[str, np.ndarray]:
        """Host copies of the physics state: qpos (B, nq), qvel (B, nv)."""
        return dict(qpos=state.data.qpos.detach().cpu().numpy().copy(),
                    qvel=state.data.qvel.detach().cpu().numpy().copy())

    def set_physics_state(self, state: EnvState, qpos, qvel) -> EnvState:
        """set_state + forward (reference `set_env_state`): qpos (B, nq)
        and qvel (B, nv), arrays or tensors, go to this env's device and
        dtype; the caches, qacc and obs are recomputed at them with the
        envs' own model fields."""
        model = _apply_var(self.model, state.var)
        d = state.data.replace(
            qpos=torch.as_tensor(qpos).to(self.device, self.dtype),
            qvel=torch.as_tensor(qvel).to(self.device, self.dtype))
        d = pipeline.forward(model, d)
        return state.replace(data=d, obs=self._obs(model, d))

    # -- success metric (reference `evaluate_success`) -------------------------

    def evaluate_success(self, goal_achieved_paths: np.ndarray) -> float:
        """% of paths whose per-step goal_achieved sums exceed the task
        threshold.  `goal_achieved_paths`: (paths, T) bool."""
        per_path = np.asarray(goal_achieved_paths).sum(axis=-1)
        return 100.0 * float((per_path > self.SUCCESS_STEPS).sum()) \
            / per_path.shape[0]
