"""The narrowphase's pair types on the card (`csrc/narrow_cyl.cu` for the
four cylinder types, `csrc/narrow_plain.cu` for plane-capsule,
plane-box, capsule-capsule, capsule-box and box-box): one thread per
(env, pair) instance computes the whole plain pair function of
`narrowphase.py`, one launch per pair-type group.

The kernels replace no TPU kernel: the JAX package leaves its
narrowphase to XLA, which fuses each pair function into a few device
programs, where PyTorch's eager mode launches each of its elementwise
ops.  Their outputs equal the plain functions' on the card bit for bit
(`csrc/narrow.cuh`'s head says how), so `narrowphase_all` takes them for
every group of these types on the float32 card path and the plain
functions everywhere else (`kernels._on_card`'s rule).  The sphere
types have no kernel.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from .. import kernels
from ..model import GEOM_PLANE, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_BOX

# Pair type -> (entry point and launch counter, contact slots C).
KERNELS = {
    (GEOM_PLANE, GEOM_CAPSULE): ("narrow_plane_capsule", 2),
    (GEOM_PLANE, GEOM_CYLINDER): ("narrow_plane_cylinder", 4),
    (GEOM_PLANE, GEOM_BOX): ("narrow_plane_box", 8),
    (GEOM_CAPSULE, GEOM_CAPSULE): ("narrow_capsule_capsule", 2),
    (GEOM_CAPSULE, GEOM_CYLINDER): ("narrow_capsule_cylinder", 2),
    (GEOM_CAPSULE, GEOM_BOX): ("narrow_capsule_box", 2),
    (GEOM_CYLINDER, GEOM_CYLINDER): ("narrow_cylinder_cylinder", 4),
    (GEOM_CYLINDER, GEOM_BOX): ("narrow_cylinder_box", 4),
    (GEOM_BOX, GEOM_BOX): ("narrow_box_box", 24),
}

# Per ModelSpec: {(device, first pair id): (geom1, geom2) int32 tensors}.
_TABLES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def group_tables(m, pids):
    """A group's geom ids (P,) int32 and pair margins (P,) on the model's
    device, for the kernel and the plain path alike: the ids uploaded
    once per model, the margins a view of the model's own `pair_margin`
    (a group's pair ids are consecutive)."""
    s, device = m.spec, m.pair_margin.device
    if pids[-1] - pids[0] + 1 != len(pids):
        raise ValueError(f"a group's pair ids are not consecutive: {pids}")
    per_spec = _TABLES.setdefault(s, {})
    key = (device, pids[0])
    if key not in per_spec:
        idx = np.asarray(pids)
        per_spec[key] = tuple(
            torch.as_tensor(np.asarray(t)[idx], dtype=torch.int32,
                            device=device)
            for t in (s.pair_geom1, s.pair_geom2))
    return per_spec[key] + (m.pair_margin[pids[0]:pids[-1] + 1],)


def narrow_cuda(key, xpos, xmat, size, g1, g2, margin):
    """(dist (B, P C), pos (B, P C, 3), nrm (B, P C, 3)) of the group of
    pair type `key` with geom ids g1, g2 (P,) int32 and pair margins
    (P,), from geom_xpos (B, ngeom, 3), geom_xmat (B, ngeom, 3, 3) and
    geom_size (ngeom, 3) or (B, ngeom, 3), all float32 on the card."""
    from .._build import load
    name, C = KERNELS[key]
    B, ngeom = xpos.shape[:2]
    P = g1.shape[0]
    kernels._check("geom_xpos", xpos, (B, ngeom, 3))
    kernels._check("geom_xmat", xmat, (B, ngeom, 3, 3))
    per_env = size.dim() == 3
    kernels._check("geom_size", size, (B, ngeom, 3) if per_env
                   else (ngeom, 3))
    kernels._check("geom1", g1, (P,), torch.int32)
    kernels._check("geom2", g2, (P,), torch.int32)
    kernels._check("margin", margin, (P,))
    dist = torch.empty((B, P * C), dtype=xpos.dtype, device=xpos.device)
    pos = torch.empty((B, P * C, 3), dtype=xpos.dtype, device=xpos.device)
    nrm = torch.empty_like(pos)
    err = getattr(load(), name)(
        xpos.data_ptr(), xmat.data_ptr(), size.data_ptr(),
        ngeom * 3 if per_env else 0, g1.data_ptr(), g2.data_ptr(),
        margin.data_ptr(), B, P, ngeom, dist.data_ptr(), pos.data_ptr(),
        nrm.data_ptr(),
        kernels._stream(xpos))
    kernels._raise_if(err, name)
    kernels.launches[name] += 1
    return dist, pos, nrm
