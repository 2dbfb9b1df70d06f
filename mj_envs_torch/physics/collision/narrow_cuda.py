"""The narrowphase's cylinder pair types on the card (`csrc/narrow_cyl.cu`):
one thread per (env, pair) instance computes the whole plain pair
function of `narrowphase.py`, one launch per pair-type group.

The kernel replaces no TPU kernel: the JAX package leaves its
narrowphase to XLA, which fuses the cylinder paths' fixed-trip loops
into a few device programs, where PyTorch's eager mode launches each of
their elementwise ops.  Its outputs equal the plain functions' on the
card bit for bit (the source's head says how), so `narrowphase_all`
takes it for every cylinder group on the float32 card path and the
plain functions everywhere else (`kernels._on_card`'s rule).

`random_cylinder_pairs` draws probe instances that reach each branch of
the four functions, for the tests (`tests/test_torch_cuda.py` holds the
kernel against the plain functions on them).
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from .. import kernels
from ..model import GEOM_PLANE, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_BOX

# Pair type -> (entry point and launch counter, contact slots C).
KERNELS = {
    (GEOM_PLANE, GEOM_CYLINDER): ("narrow_plane_cylinder", 4),
    (GEOM_CAPSULE, GEOM_CYLINDER): ("narrow_capsule_cylinder", 2),
    (GEOM_CYLINDER, GEOM_CYLINDER): ("narrow_cylinder_cylinder", 4),
    (GEOM_CYLINDER, GEOM_BOX): ("narrow_cylinder_box", 4),
}

# Per ModelSpec: {(device, first pair id): (geom1, geom2) int32 tensors}.
_TABLES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def group_tables(s, pids, device):
    """A group's geom ids on the device, uploaded once per model."""
    per_spec = _TABLES.setdefault(s, {})
    key = (device, pids[0])
    if key not in per_spec:
        idx = np.asarray(pids)
        per_spec[key] = tuple(
            torch.as_tensor(np.asarray(t)[idx], dtype=torch.int32,
                            device=device)
            for t in (s.pair_geom1, s.pair_geom2))
    return per_spec[key]


def narrow_cylinder_cuda(key, xpos, xmat, size, g1, g2):
    """(dist (B, P C), pos (B, P C, 3), nrm (B, P C, 3)) of the group of
    pair type `key` with geom ids g1, g2 (P,) int32, from geom_xpos
    (B, ngeom, 3), geom_xmat (B, ngeom, 3, 3) and geom_size (ngeom, 3)
    or (B, ngeom, 3), all float32 on the card."""
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
    dist = torch.empty((B, P * C), dtype=xpos.dtype, device=xpos.device)
    pos = torch.empty((B, P * C, 3), dtype=xpos.dtype, device=xpos.device)
    nrm = torch.empty_like(pos)
    err = getattr(load(), name)(
        xpos.data_ptr(), xmat.data_ptr(), size.data_ptr(),
        ngeom * 3 if per_env else 0, g1.data_ptr(), g2.data_ptr(), B, P,
        ngeom, dist.data_ptr(), pos.data_ptr(), nrm.data_ptr(),
        kernels._stream(xpos))
    kernels._raise_if(err, name)
    kernels.launches[name] += 1
    return dist, pos, nrm


# ---------------------------------------------------------------------------
# Probe instances (numpy, seeded)
# ---------------------------------------------------------------------------

def _rotations(rng, n):
    q = rng.standard_normal((n, 4))
    w, x, y, z = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(n, 3, 3)


def _axis_frames(rng, n):
    """Signed permutation matrices (det +1): frames along the world axes."""
    out = np.zeros((n, 3, 3))
    for i in range(n):
        p = rng.permutation(3)
        s = rng.choice([-1.0, 1.0], 3)
        m = np.eye(3)[:, p] * s
        if np.linalg.det(m) < 0:
            m[:, 0] = -m[:, 0]
        out[i] = m
    return out


def _with_axis(frames, k):
    """Each frame's columns turned so that column 2 is its column k."""
    k = np.asarray(k)
    cols = np.stack([(k + 1) % 3, (k + 2) % 3, k], -1)
    return np.take_along_axis(frames, cols[:, None, :], axis=2)


def random_cylinder_pairs(rng: np.random.Generator, key, n: int):
    """(xpos (n, 2, 3), xmat (n, 2, 3, 3), size (n, 2, 3)) float32: n
    instances of pair type `key`, geom1 at index 0 and geom2 at 1, drawn
    near contact and in quarters that reach each branch: plane-cylinder
    random and standing on the plane; capsule-cylinder random, with
    parallel and antiparallel axes; cylinder-cylinder random, stacked
    (cap on cap) and side by side with parallel axes; cylinder-box
    random, standing on a face and lying on one."""
    t1, t2 = key
    q = np.arange(n) % 4               # the quarter of each instance
    m1, m2 = _rotations(rng, n), _rotations(rng, n)
    p1 = rng.uniform(-0.5, 0.5, (n, 3))
    rad = {GEOM_CYLINDER: (0.02, 0.1), GEOM_CAPSULE: (0.01, 0.05),
           GEOM_BOX: (0.05, 0.3), GEOM_PLANE: (1.0, 1.0)}
    half = {GEOM_CYLINDER: (0.02, 0.15), GEOM_CAPSULE: (0.02, 0.1),
            GEOM_BOX: (0.05, 0.3), GEOM_PLANE: (1.0, 1.0)}

    def sizes(t):
        s = np.zeros((n, 3))
        s[:, 0] = rng.uniform(*rad[t], n)
        s[:, 1] = rng.uniform(*half[t], n)
        s[:, 2] = rng.uniform(*half[t], n) if t == GEOM_BOX else 0.0
        return s
    s1, s2 = sizes(t1), sizes(t2)
    reach = s1.max(1) + s2.max(1)
    u = rng.standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    p2 = p1 + u * (reach * rng.uniform(0.3, 1.2, n))[:, None]
    gap = rng.uniform(-0.01, 0.01, n)

    if key == (GEOM_PLANE, GEOM_CYLINDER):
        # standing: frames along the world axes, the cylinder's axis
        # along the plane's normal or against it
        st = q >= 2
        m1[st] = _axis_frames(rng, int(st.sum()))
        m2[st] = m1[st]
        flip = q == 3
        m2[flip] = m1[flip] * np.array([-1.0, 1.0, -1.0])
        nz = m1[:, :, 2]
        ca = np.abs(np.einsum("ni,ni->n", m2[:, :, 2], nz))
        lift = s2[:, 1] * ca + s2[:, 0] * np.sqrt(np.clip(1 - ca * ca, 0, 1)) \
            + gap
        slide = rng.uniform(-0.2, 0.2, (n, 3))
        slide -= nz * np.einsum("ni,ni->n", slide, nz)[:, None]
        p2 = p1 + slide + nz * lift[:, None]
    elif key == (GEOM_CAPSULE, GEOM_CYLINDER):
        par = q >= 2
        m1[par] = m2[par]
        anti = q == 3
        m1[anti] = m2[anti] * np.array([-1.0, 1.0, -1.0])
        side = np.cross(m2[:, :, 2], u)
        side /= np.linalg.norm(side, axis=1, keepdims=True)
        p2[par] = (p1 + side * (s1[:, 0] + s2[:, 0] + gap)[:, None]
                   + m2[:, :, 2] * rng.uniform(-0.05, 0.05, n)[:, None])[par]
    elif key == (GEOM_CYLINDER, GEOM_CYLINDER):
        par = q >= 2
        m2[par] = m1[par]
        ax = m1[:, :, 2]
        radial = np.cross(ax, u)
        radial /= np.linalg.norm(radial, axis=1, keepdims=True)
        cap = q == 2
        off = rng.uniform(0.0, 0.8, n) * np.maximum(s1[:, 0], s2[:, 0])
        p2[cap] = (p1 + ax * (s1[:, 1] + s2[:, 1] + gap)[:, None]
                   * rng.choice([-1.0, 1.0], n)[:, None]
                   + radial * off[:, None])[cap]
        side = q == 3
        p2[side] = (p1 + radial * (s1[:, 0] + s2[:, 0] + gap)[:, None]
                    + ax * rng.uniform(-0.1, 0.1, n)[:, None])[side]
    elif key == (GEOM_CYLINDER, GEOM_BOX):
        k = rng.integers(0, 3, n)
        sg = rng.choice([-1.0, 1.0], n)
        face_n = np.take_along_axis(m2, k[:, None, None], axis=2)[:, :, 0] \
            * sg[:, None]
        st, ly = q == 2, q == 3
        # standing: the cylinder's axis along the face normal, above it
        m1[st] = _with_axis(m2, k)[st]
        lift = s2[np.arange(n), k] + s1[:, 1] + gap
        in_face = np.einsum("nij,nj->ni", m2, rng.uniform(-0.5, 0.5, (n, 3))
                            * s2 * (np.arange(3) != k[:, None]))
        p2[st] = (p1 - face_n * lift[:, None] - in_face)[st]
        # lying: the axis along another box axis, the side on the face
        m1[ly] = _with_axis(m2, (k + 1 + rng.integers(0, 2, n)) % 3)[ly]
        lift = s2[np.arange(n), k] + s1[:, 0] + gap
        p2[ly] = (p1 - face_n * lift[:, None] - 0.3 * in_face)[ly]
    else:
        raise ValueError(f"no cylinder kernel for pair type {key}")
    f32 = lambda *xs: tuple(np.asarray(x, dtype=np.float32) for x in xs)
    return f32(np.stack([p1, p2], 1), np.stack([m1, m2], 1),
               np.stack([s1, s2], 1))
