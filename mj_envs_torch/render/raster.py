"""Batched analytic ray-caster of the PyTorch port
(`mj_envs_tpu/render/raster.py`).

The reference renders 640x480 offscreen with GL, flips the image so row 0
is the top, center-crops 128x128 and resizes to 64x64
(`headless_observer.py:34-52`).  Here the central 128x128 window is
ray-cast directly (the crop of a pinhole image is a pinhole image with
the same focal length) and box-resized to 64x64.

Geometry: analytic ray hits on plane, sphere, capsule, cylinder and box
geoms, closest hit shaded by a headlight (Lambert plus ambient 0.35),
colors from geom_rgba; triangle meshes through `meshes=` (`mesh.py`).
The four tasks ship no mesh files, so their hands are drawn from the
collision primitives.

Batch-first: `render` takes (B, ngeom, 3) geom positions and
(B, ngeom, 3, 3) orientations and returns (B, H, W, 3) float32 in
[0, 255].  Each geom-type group is intersected over its (env, geom,
pixel) candidates, the rays that pass the geom's bounding sphere.  The
selection rules are the JAX package's, so that the images agree pixel
for pixel: the nearest of a capsule's or cylinder's three parts and a
box's entry face take the first minimum; geoms of one type at the same
float32 distance are averaged; a later type group wins only where it is
strictly nearer (plane, sphere, capsule, cylinder, box, then meshes); a
geom with alpha <= 0.05 is hidden.

The ray directions are computed in float32 on the CPU, as the JAX
package computes them; from them and the float32 poses on, the hit math
runs in float64, and the distances and normals are rounded to float32
for the selection and the shading.  Whether a ray that grazes an edge
hits is decided by cancelling sums (a quadric's discriminant, a slab's
entry against its exit): in float32 the answer depends on the order of
the sums and on which products are fused into multiply-adds, which
differ between XLA, the CPU and the card.  In float64 it is the exact
answer on the float32 inputs on every device, which the JAX package's
float32 approximates.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import trace
from ..physics.model import (GEOM_BOX, GEOM_CAPSULE, GEOM_CYLINDER,
                             GEOM_PLANE, GEOM_SPHERE, Model)

BIG = 1e9
SKY = (0.2, 0.3, 0.4)
AMBIENT = 0.35


class Camera(NamedTuple):
    origin: torch.Tensor   # (3,)
    rot: torch.Tensor      # (3, 3) camera-to-world; the camera looks along -z
    focal_px: float        # focal length in pixels

    def to(self, device) -> "Camera":
        return Camera(self.origin.to(device), self.rot.to(device),
                      self.focal_px)


def _focal(fovy_deg: float, height_px: int) -> float:
    return (height_px / 2.0) / math.tan(math.radians(fovy_deg) / 2.0)


def free_camera(lookat, azimuth_deg, elevation_deg, distance,
                fovy_deg=45.0, height_px=480, device="cuda") -> Camera:
    """MuJoCo's free camera (mjv_defaultFreeCamera / mjv_cameraInModel):
    forward points from the camera to `lookat`, azimuth about +z,
    negative elevation looks down.  float32, as the JAX package."""
    f32 = torch.float32
    az = torch.deg2rad(torch.tensor(azimuth_deg, dtype=f32))
    el = torch.deg2rad(torch.tensor(elevation_deg, dtype=f32))
    forward = torch.stack([torch.cos(el) * torch.cos(az),
                           torch.cos(el) * torch.sin(az), torch.sin(el)])
    lookat = torch.as_tensor(np.asarray(lookat), dtype=f32)
    origin = lookat - distance * forward
    # camera frame: -z = forward, x = right, y = up
    world_up = torch.tensor([0.0, 0.0, 1.0], dtype=f32)
    right = torch.linalg.cross(forward, world_up)
    right = right / torch.clamp(torch.linalg.norm(right), min=1e-8)
    up = torch.linalg.cross(right, forward)
    rot = torch.stack([right, up, -forward], dim=1)
    return Camera(origin=origin.to(device), rot=rot.to(device),
                  focal_px=_focal(fovy_deg, height_px))


def fixed_camera(cam_xpos, cam_xmat, fovy_deg=45.0, height_px=480,
                 device="cuda") -> Camera:
    """A model camera (MJCF <camera>), looking along -z of its frame."""
    return Camera(
        origin=torch.as_tensor(np.asarray(cam_xpos), dtype=torch.float32,
                               device=device),
        rot=torch.as_tensor(np.asarray(cam_xmat), dtype=torch.float32,
                            device=device),
        focal_px=_focal(fovy_deg, height_px))


def _ray_dirs(cam: Camera, h: int, w: int,
              dtype=torch.float32) -> torch.Tensor:
    """(h, w, 3) unit world directions of the central (h, w) crop, in
    `dtype`; row 0 is the top of the image."""
    dev = cam.rot.device
    ys = torch.arange(h, dtype=dtype, device=dev) - (h - 1) / 2.0
    xs = torch.arange(w, dtype=dtype, device=dev) - (w - 1) / 2.0
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    d_cam = torch.stack([xx / cam.focal_px, -yy / cam.focal_px,
                         -torch.ones_like(xx)], dim=-1)
    d_world = d_cam @ cam.rot.to(dtype).T
    return d_world / torch.linalg.norm(d_world, dim=-1, keepdim=True)


def camera_rays(cam: Camera, h: int, w: int, device) -> torch.Tensor:
    """The (h, w, 3) ray directions `render` casts, float32 computed on
    the CPU as the JAX package computes them, then float64 on `device`:
    the same values on every device (a ray's direction, 4.5 m from the
    scene, is the input a grazing hit is most sensitive to).  A caller
    that renders one camera often computes them once and passes them as
    `render(..., dirs=)`."""
    return _ray_dirs(cam.to("cpu"), h, w).to(device, torch.float64)


@functools.lru_cache(maxsize=None)
def _type_gids(geom_type: tuple, t_id: int, device: str) -> torch.Tensor:
    """The ids of the geoms of type `t_id`, on `device` (one copy per
    model and device)."""
    return torch.as_tensor(np.nonzero(np.asarray(geom_type) == t_id)[0],
                           device=device)


# -- analytic ray-primitive hits -------------------------------------------
# o, d: (..., 3) ray origins and directions in the geom's frame; size:
# (..., 3) broadcastable against them.  Each returns (t, normal) with
# t = BIG on a miss, in the dtype of its inputs.

def _big(t: torch.Tensor) -> torch.Tensor:
    return torch.full_like(t, BIG)


def _axis_z(o: torch.Tensor, d: torch.Tensor, sign=1.0) -> torch.Tensor:
    n = torch.zeros(3, dtype=d.dtype, device=d.device)
    n[2] = sign
    return n.expand(torch.broadcast_shapes(o.shape, d.shape))


def _hit_plane(o, d, size):
    # the plane z = 0 with normal +z, hit from either side
    dz_ok = d[..., 2].abs() > 1e-9
    t = -o[..., 2] / torch.where(dz_ok, d[..., 2],
                                 torch.full_like(d[..., 2], 1e-9))
    ok = (t > 1e-4) & dz_ok
    return torch.where(ok, t, _big(t)), _axis_z(o, d)


def _hit_sphere(o, d, size):
    r = size[..., 0]
    b = (o * d).sum(-1)
    c = (o * o).sum(-1) - r * r
    disc = b * b - c
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    ok = (disc > 0) & (t > 1e-4)
    p = o + t[..., None] * d
    return torch.where(ok, t, _big(t)), p / torch.clamp(r, min=1e-9)[..., None]


def _hit_zcyl_side(o, d, r, hl):
    a = d[..., 0] ** 2 + d[..., 1] ** 2
    b = o[..., 0] * d[..., 0] + o[..., 1] * d[..., 1]
    c = o[..., 0] ** 2 + o[..., 1] ** 2 - r * r
    disc = b * b - a * c
    t = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) \
        / torch.clamp(a, min=1e-12)
    z = o[..., 2] + t * d[..., 2]
    ok = (disc > 0) & (t > 1e-4) & (z.abs() <= hl) & (a > 1e-12)
    p = o + t[..., None] * d
    n = torch.stack([p[..., 0] / r, p[..., 1] / r,
                     torch.zeros_like(p[..., 2])], dim=-1)
    return torch.where(ok, t, _big(t)), n


def _hit_zdisk(o, d, r, z0, nz):
    dz_ok = d[..., 2].abs() > 1e-9
    t = (z0 - o[..., 2]) / torch.where(dz_ok, d[..., 2],
                                       torch.full_like(d[..., 2], 1e-9))
    p = o + t[..., None] * d
    ok = (t > 1e-4) & (p[..., 0] ** 2 + p[..., 1] ** 2 <= r * r) & dz_ok
    return torch.where(ok, t, _big(t)), _axis_z(o, d, nz)


def _min3(t1, n1, t2, n2, t3, n3):
    """The nearest of three hits; the first minimum wins a tie."""
    t = torch.minimum(torch.minimum(t1, t2), t3)
    n = torch.where((t == t1)[..., None], n1,
                    torch.where((t == t2)[..., None], n2, n3))
    return t, n


def _hit_cylinder(o, d, size):
    r, hl = size[..., 0], size[..., 1]
    t1, n1 = _hit_zcyl_side(o, d, r, hl)
    t2, n2 = _hit_zdisk(o, d, r, hl, 1.0)
    t3, n3 = _hit_zdisk(o, d, r, -hl, -1.0)
    return _min3(t1, n1, t2, n2, t3, n3)


def _hit_capsule(o, d, size):
    r, hl = size[..., 0], size[..., 1]
    t1, n1 = _hit_zcyl_side(o, d, r, hl)
    # end spheres at z = +-hl, each valid on its own hemisphere
    zero = torch.zeros_like(hl)
    ez = torch.stack([zero, zero, hl], dim=-1)
    o_top, o_bot = o - ez, o + ez
    rrr = torch.stack([r, r, r], dim=-1)
    t2, n2 = _hit_sphere(o_top, d, rrr)
    t3, n3 = _hit_sphere(o_bot, d, rrr)
    z2 = o_top[..., 2] + t2 * d[..., 2]
    t2 = torch.where(z2 >= 0, t2, _big(t2))
    z3 = o_bot[..., 2] + t3 * d[..., 2]
    t3 = torch.where(z3 <= 0, t3, _big(t3))
    return _min3(t1, n1, t2, n2, t3, n3)


def _hit_box(o, d, size):
    inv = 1.0 / torch.where(d.abs() > 1e-9, d, torch.full_like(d, 1e-9))
    t0 = (-size - o) * inv
    t1 = (size - o) * inv
    tmin = torch.minimum(t0, t1)
    tmax = torch.maximum(t0, t1)
    t_near = tmin.amax(-1)
    t_far = tmax.amin(-1)
    ok = (t_near < t_far) & (t_near > 1e-4)
    p = o + t_near[..., None] * d
    # the entry face: the first axis whose slab entry is t_near
    e0 = tmin[..., 0] == t_near
    e1 = (tmin[..., 1] == t_near) & ~e0
    e2 = ~e0 & ~e1
    n = torch.stack([e0, e1, e2], dim=-1).to(o.dtype) * torch.sign(p)
    return torch.where(ok, t_near, _big(t_near)), n


_HITS = {GEOM_PLANE: _hit_plane, GEOM_SPHERE: _hit_sphere,
         GEOM_CAPSULE: _hit_capsule, GEOM_CYLINDER: _hit_cylinder,
         GEOM_BOX: _hit_box}


class MeshInstances(NamedTuple):
    """Posed mesh geoms for `render` (see `mesh.py`)."""
    bank: "object"            # mesh.MeshBank
    meshid: np.ndarray        # (Gm,) mesh index of each instance
    pos: torch.Tensor         # (B, Gm, 3) world position
    mat: torch.Tensor         # (B, Gm, 3, 3) world orientation
    rgba: torch.Tensor        # (Gm, 4) or (B, Gm, 4)


def _per_env(x: torch.Tensor, B: int, lead: int) -> torch.Tensor:
    """`x` with a leading env axis of B: as it is when it has one (it has
    `lead` + 2 dims), else expanded."""
    return x if x.dim() == lead + 2 else x.expand((B,) + x.shape)


# The bounding radius of each primitive about its center, from its size.
_RADIUS = {
    GEOM_SPHERE: lambda sz: sz[..., 0],
    GEOM_CAPSULE: lambda sz: sz[..., 0] + sz[..., 1],
    GEOM_CYLINDER: lambda sz: torch.sqrt(sz[..., 0] ** 2 + sz[..., 1] ** 2),
    GEOM_BOX: lambda sz: torch.linalg.norm(sz, dim=-1),
}


# Three-term sums written out: elementwise kernels, the same roundings on
# every device (a batched 3x3 matmul in float64 went to slow gemv
# kernels on the card).

def _dot3(a, b):
    """sum_k a[..., k] b[..., k], broadcasting."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def _vec_mat(v, R):
    """v (K, 3) times R (K, 3, 3): sum_i v[:, i] R[:, i, :]."""
    return v[:, 0:1] * R[:, 0] + v[:, 1:2] * R[:, 1] + v[:, 2:3] * R[:, 2]


def _group_hits(pos, mat, radius, visible, dirs, o_w, hit):
    """The hits of one group of G geoms on every ray, sparse: only the
    (env, geom, pixel) candidates whose ray passes within the geom's
    bounding sphere, widened by 1 % + 1e-3, and not wholly behind the
    camera.  A ray outside it misses, as the dense intersection would
    find.  pos (B, G, 3), mat (B, G, 3, 3), dirs (H, W, 3) and o_w (3,)
    in float64; `radius` (B, G), None for unbounded geoms (planes);
    hit(o_l, d_l, b, g) -> (t, n_l) of K candidates in the geom's frame.
    Returns the candidates' flat pixel index (b H + h) W + w, geom
    index, t and world normal, t and normal in float32."""
    B, G = pos.shape[:2]
    H, W = dirs.shape[:2]
    if radius is None:
        cand = visible[:, :, None, None].expand(B, G, H, W)
    else:
        rel = (pos - o_w)[:, :, None, None, :]             # camera -> center
        along = _dot3(dirs, rel)                           # (B, G, H, W)
        dist2 = _dot3(rel, rel) - along * along
        rad = (radius * 1.01 + 1e-3)[..., None, None]
        cand = (dist2 <= rad * rad) & (along + rad > 0) \
            & visible[:, :, None, None]
    b, g, h, w = cand.nonzero(as_tuple=True)
    R = mat[b, g]                                          # (K, 3, 3)
    o_l = _vec_mat(o_w - pos[b, g], R)                     # R^T (o - p)
    d_l = _vec_mat(dirs[h, w], R)
    t, n_l = hit(o_l, d_l, b, g)
    n_w = _vec_mat(n_l, R.transpose(1, 2))                 # R n
    f32 = torch.float32
    return (b * H + h) * W + w, g, t.to(f32), n_w.to(f32)


def _merge(pix, t, n_w, rgb, best):
    """Fold one group's candidate hits into the running per-pixel (t,
    rgb, normal), flat over B H W: within the group the nearest hit, tied
    geoms averaged; the group wins where strictly nearer than what came
    before."""
    best_t, best_rgb, best_n = best
    hit = t < BIG
    pix, t, n_w, rgb = pix[hit], t[hit], n_w[hit], rgb[hit]
    t_grp = torch.full_like(best_t, BIG).scatter_reduce(
        0, pix, t, "amin", include_self=True)
    win = t <= t_grp[pix]
    pix, n_w, rgb = pix[win], n_w[win], rgb[win]
    cnt = torch.zeros_like(best_t).index_add_(
        0, pix, torch.ones_like(t[win])).clamp(min=1.0)[:, None]
    n_grp = torch.zeros_like(best_n).index_add_(0, pix, n_w) / cnt
    rgb_grp = torch.zeros_like(best_rgb).index_add_(0, pix, rgb) / cnt
    upd = t_grp < best_t
    return (torch.where(upd, t_grp, best_t),
            torch.where(upd[:, None], rgb_grp, best_rgb),
            torch.where(upd[:, None], n_grp, best_n))


def render(model: Model, geom_xpos: torch.Tensor, geom_xmat: torch.Tensor,
           cam: Camera, height: int = 128, width: int = 128,
           light_dir=(0.0, 0.0, -1.0), ambient: float = AMBIENT,
           meshes: Optional[MeshInstances] = None,
           dirs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-> (B, height, width, 3) float32 in [0, 255] (the reference's
    observer returns float images in [0, 255], `headless_observer.py:52`).

    geom_xpos (B, ngeom, 3) and geom_xmat (B, ngeom, 3, 3) are the geom
    poses; `model.geom_size` / `geom_rgba` may carry a leading env axis
    (per-env model fields, `envs.base._apply_var`).  `dirs` are
    `camera_rays(cam, height, width, device)`, computed here when not
    given.  One chunk is the tracer's span `render.chunk`."""
    with trace.span("render.chunk"):
        return _render(model, geom_xpos, geom_xmat, cam, height, width,
                       light_dir, ambient, meshes, dirs)


def _render(model, geom_xpos, geom_xmat, cam, height, width, light_dir,
            ambient, meshes, dirs) -> torch.Tensor:
    f32, f64 = torch.float32, torch.float64
    B = geom_xpos.shape[0]
    dev = cam.origin.device
    if dirs is None:
        dirs = camera_rays(cam, height, width, dev)           # (H, W, 3)
    o_w = cam.origin.to(f64)
    # float32 poses and sizes, as the JAX package renders, widened
    geom_xpos = geom_xpos.to(f32).to(f64)
    geom_xmat = geom_xmat.to(f32).to(f64)
    size_all = _per_env(model.geom_size.to(f32).to(f64), B, 1)
    rgba_all = _per_env(model.geom_rgba.to(f32), B, 1)
    gt = tuple(np.asarray(model.spec.geom_type).tolist())

    n = B * height * width
    best = (torch.full((n,), BIG, dtype=f32, device=dev),
            torch.zeros((n, 3), dtype=f32, device=dev),
            torch.zeros((n, 3), dtype=f32, device=dev))

    for t_id, fn in _HITS.items():
        gids = _type_gids(gt, t_id, str(dev))
        if len(gids) == 0:
            continue
        size = size_all[:, gids]
        rgba = rgba_all[:, gids]
        radius = _RADIUS[t_id](size) if t_id in _RADIUS else None
        pix, g, t, n_w = _group_hits(
            geom_xpos[:, gids], geom_xmat[:, gids], radius,
            rgba[..., 3] > 0.05, dirs, o_w,
            lambda o, d, b, g: fn(o, d, size[b, g]))
        best = _merge(pix, t, n_w, rgba[pix // (height * width), g, :3],
                      best)

    if meshes is not None:
        from .mesh import hit_mesh
        tris = meshes.bank.tris.to(dev, f64)
        meshid = torch.as_tensor(np.asarray(meshes.meshid), device=dev)
        mrad = torch.linalg.norm(tris, dim=-1).amax((1, 2))[meshid]
        mrgba = _per_env(meshes.rgba.to(f32), B, 1)

        def hit(o, d, b, g):
            t = torch.full_like(o[:, 0], BIG)
            nrm = torch.zeros_like(o)
            for gi, mid in enumerate(np.asarray(meshes.meshid)):
                sel = g == gi
                t[sel], nrm[sel] = hit_mesh(o[sel], d[sel], tris[int(mid)])
            return t, nrm

        pix, g, t, n_w = _group_hits(
            meshes.pos.to(f32).to(f64), meshes.mat.to(f32).to(f64),
            mrad.expand(B, -1), mrgba[..., 3] > 0.05, dirs, o_w, hit)
        best = _merge(pix, t, n_w, mrgba[pix // (height * width), g, :3],
                      best)

    ldir = torch.tensor(light_dir, dtype=f32, device=dev)
    ldir = ldir / torch.linalg.norm(ldir)
    best_t, best_rgb, best_n = best
    hit = best_t < BIG
    lam = torch.clamp(-(best_n * ldir).sum(-1), 0.0, 1.0)
    shade = ambient + (1.0 - ambient) * lam
    sky = torch.tensor(SKY, dtype=f32, device=dev)
    img = torch.where(hit[:, None], best_rgb * shade[:, None], sky)
    return torch.clamp(img * 255.0, 0.0, 255.0).reshape(B, height, width, 3)


def resize_half(img: torch.Tensor) -> torch.Tensor:
    """(..., 2h, 2w, C) -> (..., h, w, C): the mean of each 2x2 block
    (bilinear downsampling by an exact factor of 2)."""
    *lead, h, w, c = img.shape
    x = img.reshape(*lead, h // 2, 2, w // 2, 2, c)
    return x.sum(dim=(-4, -2)) / 4.0


def images_to_observation(img_u8: torch.Tensor, bit_depth: int,
                          generator: Optional[torch.Generator] = None,
                          noise: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """PlaNet's preprocessing (`_images_to_observation`): quantize to
    `bit_depth` bits, center to [-0.5, 0.5], and add dequantization noise
    U[0, 1) / 2^bit_depth, drawn from `generator` or given as `noise`
    (none when neither is)."""
    x = torch.floor_divide(img_u8.to(torch.float32), 2 ** (8 - bit_depth))
    x = x / (2 ** bit_depth) - 0.5
    if noise is None and generator is not None:
        noise = torch.rand(x.shape, generator=generator, device=x.device,
                           dtype=x.dtype)
    if noise is not None:
        x = x + noise.to(x.device, x.dtype) / (2 ** bit_depth)
    return x
