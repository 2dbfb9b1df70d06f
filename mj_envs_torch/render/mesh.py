"""Triangle meshes for the ray-caster of the PyTorch port
(`mj_envs_tpu/render/mesh.py`).

The reference draws the ShadowHand from STL meshes of the Adroit assets
(`DAPG_assets.xml`), visual-only geoms.  Those files are absent from the
repository, so the four tasks render the hand from its collision
primitives; this module lets a model with mesh geoms be rendered:

- `load_stl(path)`: a binary or ASCII STL file -> (V, F) arrays;
- `MeshBank`: meshes packed into one padded triangle tensor, indexed by
  mesh id; padding triangles never hit;
- `hit_mesh(o, d, tris)`: Möller-Trumbore closest hit over a padded
  triangle set, used by `raster.render(..., meshes=...)`.
"""
from __future__ import annotations

import struct as _struct
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

BIG = 1e9


def load_stl(path: str, scale: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Read an STL file -> (vertices (V, 3) float32, faces (F, 3) int32),
    binary or ASCII; vertices de-duplicated exactly, times `scale` (MJCF's
    `<mesh scale=...>`)."""
    with open(path, "rb") as f:
        head = f.read(5)
        f.seek(0)
        if head == b"solid":
            tris = _read_ascii_stl(f.read().decode("ascii", "replace"))
        else:
            f.seek(80)
            (n,) = _struct.unpack("<I", f.read(4))
            raw = np.frombuffer(f.read(n * 50), dtype=np.uint8)
            raw = raw.reshape(n, 50)
            tris = raw[:, 12:48].copy().view(np.float32).reshape(n, 3, 3)
    verts, inv = np.unique(tris.reshape(-1, 3), axis=0,
                           return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    return (verts * scale).astype(np.float32), faces


def _read_ascii_stl(text: str) -> np.ndarray:
    pts: List[List[float]] = []
    for line in text.splitlines():
        t = line.split()
        if t and t[0] == "vertex":
            pts.append([float(t[1]), float(t[2]), float(t[3])])
    return np.asarray(pts, np.float32).reshape(-1, 3, 3)


class MeshBank(NamedTuple):
    """All meshes packed into one (nmesh, tmax, 3, 3) tensor; a padding
    slot holds a degenerate triangle (three vertices at one far point)
    that no ray hits."""
    tris: torch.Tensor       # (nmesh, tmax, 3, 3) float32, local frame
    ntri: np.ndarray         # (nmesh,) int32 triangle counts

    @staticmethod
    def pack(meshes: Sequence[Tuple[np.ndarray, np.ndarray]],
             device="cuda") -> "MeshBank":
        """meshes: a list of (verts (V, 3), faces (F, 3)) as `load_stl`
        returns them."""
        tmax = max(int(f.shape[0]) for _, f in meshes)
        out = np.full((len(meshes), tmax, 3, 3), 1e6, np.float32)
        ntri = np.zeros(len(meshes), np.int32)
        for i, (v, f) in enumerate(meshes):
            out[i, : f.shape[0]] = v[f]
            ntri[i] = f.shape[0]
        return MeshBank(tris=torch.as_tensor(out, device=device), ntri=ntri)


def hit_mesh(o: torch.Tensor, d: torch.Tensor, tris: torch.Tensor):
    """Möller-Trumbore closest hit.

    o, d: (..., 3) ray origins and directions in the geom's frame; tris:
    (T, 3, 3).  Returns (t, n): t = BIG on a miss, n the unit geometric
    normal of the nearest triangle (the first of equals), turned against
    the ray."""
    tris = tris.to(d.dtype)
    v0 = tris[:, 0]                                    # (T, 3)
    e1 = tris[:, 1] - v0
    e2 = tris[:, 2] - v0
    lead = (1,) * (d.dim() - 1)

    def per_tri(x):                                    # (T, 3) -> (T,1..,3)
        return x.reshape((x.shape[0],) + lead + (3,))

    v0b, e1b, e2b = per_tri(v0), per_tri(e1), per_tri(e2)
    p = torch.linalg.cross(d.expand(e2b.shape[:1] + d.shape), e2b.expand(
        e2b.shape[:1] + d.shape), dim=-1)              # (T, ..., 3)
    det = (e1b * p).sum(-1)
    det_ok = det.abs() > 1e-12
    inv = 1.0 / torch.where(det_ok, det, torch.full_like(det, 1e-12))
    s = o - v0b
    u = (s * p).sum(-1) * inv
    q = torch.linalg.cross(s, e1b.expand(s.shape), dim=-1)
    v = (d * q).sum(-1) * inv
    t = (e2b * q).sum(-1) * inv
    ok = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-4)
    ts = torch.where(ok, t, torch.full_like(t, BIG))   # (T, ...)
    t_min, i = ts.min(0)
    n = torch.linalg.cross(e1, e2, dim=-1)             # (T, 3)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                        min=1e-12)
    n_hit = n[i]                                       # (..., 3)
    # two-sided shading: the normal against the ray
    flip = (n_hit * d).sum(-1, keepdim=True) > 0
    return t_min, torch.where(flip, -n_hit, n_hit)
