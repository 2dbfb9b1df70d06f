"""Model / Data containers of the PyTorch port (`mj_envs_tpu/physics/model.py`).

* ``ModelSpec`` — static structure: sizes, topology, index arrays,
  constraint layout (numpy; shared by all envs).
* ``Model`` — numeric parameters as tensors.  Unbatched except for the
  fields a task randomizes per env (`envs.base.ModelVar`), which carry a
  leading env axis; every consumer indexes those with ``[..., i, :]`` so
  both forms broadcast.
* ``Data`` — per-env dynamic state + cached forward products, batch-first
  (leading env axis on every field), with MjData-after-mj_step semantics:
  the kinematic caches are those of the last forward pass.

The suite has only hinge/slide joints, so ``nq == nv``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

# Joint types (MuJoCo enum values).
JNT_SLIDE = 2
JNT_HINGE = 3

# Geom types (MuJoCo enum values).
GEOM_PLANE = 0
GEOM_SPHERE = 2
GEOM_CAPSULE = 3
GEOM_ELLIPSOID = 4
GEOM_CYLINDER = 5
GEOM_BOX = 6
GEOM_MESH = 7

# Constraint-row type enum (MuJoCo's efc ordering).
EFC_FRICTION_DOF = 0
EFC_LIMIT_JOINT = 1
EFC_LIMIT_TENDON = 2
EFC_CONTACT = 3


class ModelSpec:
    """Static model structure (numpy arrays and Python scalars)."""

    def __init__(self, **kw: Any):
        self.nq = self.nv = self.nu = self.nbody = self.njnt = 0
        self.ngeom = self.nsite = self.ncam = self.nten = 0
        self.nsensor = self.nsensordata = 0
        self.npair = self.ncon_cap = self.nefc_cap = 0
        self.sensors: Tuple[Tuple[str, int, int, int], ...] = ()
        self.names: Dict[str, Dict[str, int]] = {}
        self.timestep = 0.002
        self.gravity = np.array([0.0, 0.0, -9.81])
        self.iterations = 100
        self.noslip_iterations = 0
        self.tolerance = 1e-8
        self.noslip_tolerance = 1e-6
        self.impratio = 1.0
        self.model_name = ""
        for k, v in kw.items():
            setattr(self, k, v)

    def name2id(self, kind: str, name: str) -> int:
        return self.names[kind][name]


@dataclasses.dataclass
class Model:
    """Numeric model parameters (tensors; shapes as in the JAX Model)."""

    spec: ModelSpec

    qpos0: torch.Tensor
    body_pos: torch.Tensor
    body_quat: torch.Tensor
    body_ipos: torch.Tensor
    body_iquat: torch.Tensor
    body_mass: torch.Tensor
    body_inertia: torch.Tensor
    body_invweight0: torch.Tensor
    jnt_pos: torch.Tensor
    jnt_axis: torch.Tensor
    jnt_range: torch.Tensor
    jnt_margin: torch.Tensor
    jnt_stiffness: torch.Tensor
    jnt_springref: torch.Tensor
    jnt_solref_lim: torch.Tensor
    jnt_solimp_lim: torch.Tensor
    dof_damping: torch.Tensor
    dof_armature: torch.Tensor
    dof_frictionloss: torch.Tensor
    dof_solref_fri: torch.Tensor
    dof_solimp_fri: torch.Tensor
    dof_invweight0: torch.Tensor
    geom_pos: torch.Tensor
    geom_quat: torch.Tensor
    geom_size: torch.Tensor
    geom_rgba: torch.Tensor
    site_pos: torch.Tensor
    site_quat: torch.Tensor
    site_size: torch.Tensor
    cam_pos: torch.Tensor
    cam_quat: torch.Tensor
    ten_coef: torch.Tensor
    ten_range: torch.Tensor
    ten_margin: torch.Tensor
    ten_solref_lim: torch.Tensor
    ten_solimp_lim: torch.Tensor
    ten_invweight0: torch.Tensor
    act_gainprm: torch.Tensor
    act_biasprm: torch.Tensor
    act_ctrlrange: torch.Tensor
    act_forcerange: torch.Tensor
    act_forcelimited: torch.Tensor
    pair_friction: torch.Tensor
    pair_margin: torch.Tensor
    pair_gap: torch.Tensor
    pair_solref: torch.Tensor
    pair_solimp: torch.Tensor

    @staticmethod
    def leaf_names() -> Tuple[str, ...]:
        return tuple(f.name for f in dataclasses.fields(Model)
                     if f.name != "spec")

    @classmethod
    def from_numpy(cls, arrays: Dict[str, np.ndarray], spec: ModelSpec,
                   device="cuda", dtype=None) -> "Model":
        """Model from numpy leaves, e.g. a JAX `Model`'s leaves, so the
        two packages compute on identical arrays.  Float leaves keep their
        dtype unless `dtype` is given; bool leaves stay bool."""
        leaves = {}
        for name in cls.leaf_names():
            a = np.asarray(arrays[name])
            t = torch.as_tensor(a.copy(), device=device)
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            leaves[name] = t
        return cls(spec=spec, **leaves)

    def replace(self, **kw) -> "Model":
        return dataclasses.replace(self, **kw)

    def to(self, device=None, dtype=None) -> "Model":
        kw = {}
        for name in self.leaf_names():
            t = getattr(self, name)
            kw[name] = t.to(device=device, dtype=dtype) \
                if t.is_floating_point() else t.to(device=device)
        return self.replace(**kw)

    @property
    def dtype(self) -> torch.dtype:
        return self.qpos0.dtype

    @property
    def device(self) -> torch.device:
        return self.qpos0.device


@dataclasses.dataclass
class Data:
    """Per-env dynamic state + cached forward products; every field has
    a leading env axis (B, ...)."""

    qpos: torch.Tensor            # (B, nq)
    qvel: torch.Tensor            # (B, nv)
    ctrl: torch.Tensor            # (B, nu)
    qacc: torch.Tensor            # (B, nv)
    qacc_warmstart: torch.Tensor  # (B, nv)
    qfrc_applied: torch.Tensor    # (B, nv)
    time: torch.Tensor            # (B,)
    xpos: torch.Tensor            # (B, nbody, 3)
    xquat: torch.Tensor           # (B, nbody, 4)
    xipos: torch.Tensor           # (B, nbody, 3)
    geom_xpos: torch.Tensor       # (B, ngeom, 3)
    geom_xmat: torch.Tensor       # (B, ngeom, 3, 3)
    site_xpos: torch.Tensor       # (B, nsite, 3)
    site_xmat: torch.Tensor       # (B, nsite, 3, 3)
    subtree_com: torch.Tensor     # (B, nbody, 3)
    ten_length: torch.Tensor      # (B, nten)
    actuator_force: torch.Tensor  # (B, nu)
    sensordata: torch.Tensor      # (B, nsensordata)
    efc_force: torch.Tensor       # (B, nefc_cap)
    ncon_active: torch.Tensor     # (B,) int32 — in-margin contacts before
                                  # compaction (> ncmax: some were dropped)

    @staticmethod
    def field_names() -> Tuple[str, ...]:
        return tuple(f.name for f in dataclasses.fields(Data))

    def replace(self, **kw) -> "Data":
        return dataclasses.replace(self, **kw)



def make_data(model: Model, batch: int, dtype=None) -> Data:
    """Zero-initialized Data at qpos0 for `batch` envs (kinematic caches
    not yet computed — run pipeline.forward / forward_light)."""
    s = model.spec
    dtype = dtype or model.dtype
    dev = model.device

    def z(*shape):
        return torch.zeros((batch,) + shape, dtype=dtype, device=dev)

    def tile(x, n):
        return x.to(dtype).expand((batch, n) + x.shape).clone()

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    unit_q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=dev)
    return Data(
        qpos=model.qpos0.to(dtype).expand(batch, s.nq).clone(),
        qvel=z(s.nv), ctrl=z(s.nu), qacc=z(s.nv), qacc_warmstart=z(s.nv),
        qfrc_applied=z(s.nv), time=z(),
        xpos=z(s.nbody, 3), xquat=tile(unit_q, s.nbody),
        xipos=z(s.nbody, 3), geom_xpos=z(s.ngeom, 3),
        geom_xmat=tile(eye3, s.ngeom), site_xpos=z(s.nsite, 3),
        site_xmat=tile(eye3, s.nsite), subtree_com=z(s.nbody, 3),
        ten_length=z(s.nten), actuator_force=z(s.nu),
        sensordata=z(s.nsensordata), efc_force=z(s.nefc_cap),
        ncon_active=torch.zeros(batch, dtype=torch.int32, device=dev),
    )
