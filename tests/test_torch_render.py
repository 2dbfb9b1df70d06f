"""The port's ray-cast renderer (`mj_envs_torch/render/`) against the JAX
package's (`mj_envs_tpu/render/`), CPU.

* The five analytic hits and `hit_mesh` on seeded random rays, float64
  and float32: the same hit or miss on every ray, and where both hit,
  the same distance and normal within the tolerances below.
* a mesh cube in place of hammer's first box, against the JAX
  package's mesh render and the analytic box: at most 0.5 % of the
  pixels may differ by more than 1.0 (of 255), the share
  `tests/test_vision.py` allows a mesh against its analytic box.
* The JAX golden image: the JAX reset state of `test_raster_golden_image`
  (PRNGKey(0)) moved into the port with `set_physics_state` and rendered
  64x64 against `tests/golden/raster_hammer64.npy` at max |diff| < 2.0,
  that test's own bound.  The golden file is only read.
* `resize_half` and `images_to_observation` on the same inputs.

Each task's camera and whole images are in `test_torch_render_tasks.py`.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mj_envs_tpu import envs as jenvs
from mj_envs_tpu.envs.pixels import PixelObservationEnv as JPixels
from mj_envs_tpu.physics import kinematics as JK
from mj_envs_tpu.physics.model import JNT_HINGE, JNT_SLIDE
from mj_envs_tpu.render import mesh as JM
from mj_envs_tpu.render import raster as JR
from mj_envs_torch import envs as tenvs
from mj_envs_torch.envs.pixels import PixelObservationEnv as TPixels
from mj_envs_torch.render import mesh as TM
from mj_envs_torch.render import raster as TR

TASKS = ("hammer-v0", "door-v0", "pen-v0", "relocate-v0")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "raster_hammer64.npy")
NP = {torch.float64: np.float64, torch.float32: np.float32}
# The share of pixels that may differ by more than 1.0 (of 255).
PIXEL_SHARE = 0.005


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)    # six xdist workers share the CPU
    yield
    torch.set_num_threads(n)


_PAIRS = {}


def pixel_pair(task):
    """The JAX and the port's PixelObservationEnv of `task` (cached)."""
    if task not in _PAIRS:
        _PAIRS[task] = (JPixels(jenvs.make(task)),
                        TPixels(tenvs.make(task, device="cpu")))
    return _PAIRS[task]


# -- the hit functions ------------------------------------------------------

def random_rays(seed, G, N, dtype):
    """G geoms of random size, N rays each: origins in [-2, 2]^3, unit
    directions, half the rays aimed near the origin so that they hit."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.0, 2.0, (G, N, 3))
    aim = rng.uniform(-0.3, 0.3, (G, N, 3)) - o
    d = np.where(rng.uniform(size=(G, N, 1)) < 0.5, aim,
                 rng.standard_normal((G, N, 3)))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    size = rng.uniform(0.1, 1.0, (G, 3))
    f = NP[dtype]
    return o.astype(f), d.astype(f), size.astype(f)


def hit_errors(t_j, n_j, t_t, n_t):
    """(rays whose hit or miss differs, max relative t error, max normal
    error) over the rays both hit."""
    t_j, n_j = np.asarray(t_j, np.float64), np.asarray(n_j, np.float64)
    t_t, n_t = t_t.double().numpy(), n_t.double().numpy()
    hit_j, hit_t = t_j < JR.BIG, t_t < TR.BIG
    both = hit_j & hit_t
    rel = np.abs(t_t - t_j)[both] / np.abs(t_j)[both]
    nerr = np.abs(n_t - n_j)[both]
    return (int((hit_j != hit_t).sum()), float(rel.max()),
            float(nerr.max()), int(both.sum()))


# (max relative t error, max normal error) where both hit, and how many
# rays may flip between hit and miss: 4x the worst over seeds 0-2 of the
# five hits and the mesh (`random_rays`, 4000 rays each; no ray flipped).
# float64: t 2.3e-15, normal 6.7e-16 (a sphere normal p / r at r ~ 0.1);
# float32: t 7.6e-5, normal 1.3e-5 (`render` runs them in float64).
HIT_TOL = {torch.float64: (1e-14, 3e-15, 0),
           torch.float32: (3.1e-4, 5.2e-5, 0)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", ["plane", "sphere", "capsule", "cylinder",
                                  "box"])
def test_hits_match_jax(name, dtype):
    from mj_envs_tpu.physics import model as JMod
    gtype = getattr(JMod, "GEOM_" + name.upper())
    o, d, size = random_rays(0, 8, 500, dtype)
    t_j, n_j = jax.vmap(JR._HITS[gtype])(jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(size))
    t_t, n_t = TR._HITS[gtype](torch.as_tensor(o), torch.as_tensor(d),
                               torch.as_tensor(size)[:, None, :])
    assert t_t.dtype == dtype and n_t.shape == (8, 500, 3)
    flips, rel, nerr, nboth = hit_errors(t_j, n_j, t_t, n_t)
    t_tol, n_tol, max_flips = HIT_TOL[dtype]
    assert nboth > 500, nboth                # the rays really hit
    assert flips <= max_flips and rel <= t_tol and nerr <= n_tol, \
        (flips, rel, nerr)


def cube_tris(half=1.0):
    """A closed cube's 12 triangles (3, 3) each, outward winding."""
    v = np.array([[x, y, z] for x in (-half, half) for y in (-half, half)
                  for z in (-half, half)], np.float64)
    faces = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5),
             (0, 5, 1), (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4),
             (1, 5, 7), (1, 7, 3)]
    return v[np.array(faces)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_hit_mesh_matches_jax(dtype):
    """A cube's triangles plus two padding slots: the tolerances of the
    analytic hits."""
    o, d, _ = random_rays(1, 1, 2000, dtype)
    tris = np.concatenate([cube_tris(0.5), np.full((2, 3, 3), 1e6)]) \
        .astype(NP[dtype])
    t_j, n_j = JM.hit_mesh(jnp.asarray(o[0]), jnp.asarray(d[0]),
                           jnp.asarray(tris))
    t_t, n_t = TM.hit_mesh(torch.as_tensor(o[0]), torch.as_tensor(d[0]),
                           torch.as_tensor(tris))
    flips, rel, nerr, nboth = hit_errors(t_j, n_j, t_t, n_t)
    t_tol, n_tol, max_flips = HIT_TOL[dtype]
    assert nboth > 200 and flips <= max_flips and rel <= t_tol \
        and nerr <= n_tol, (flips, rel, nerr, nboth)


def write_stl(path, tris, ascii_=False):
    """`tris` (T, 3, 3) as a binary or an ASCII STL file."""
    import struct
    if ascii_:
        lines = ["solid cube"]
        for t in tris:
            lines += ["facet normal 0 0 0", "outer loop"]
            lines += [f"vertex {x:.9g} {y:.9g} {z:.9g}" for x, y, z in t]
            lines += ["endloop", "endfacet"]
        with open(path, "w") as f:
            f.write("\n".join(lines + ["endsolid cube"]) + "\n")
        return
    with open(path, "wb") as f:
        f.write(b"\0" * 80 + struct.pack("<I", len(tris)))
        for t in tris:
            f.write(struct.pack("<3f", 0, 0, 0))
            for v in t:
                f.write(struct.pack("<3f", *v))
            f.write(struct.pack("<H", 0))


def test_mesh_render_matches_jax(tmp_path):
    """`load_stl` of a binary and an ASCII cube equals the JAX package's;
    hammer's first visible box drawn as that cube's mesh (the box
    hidden) renders as the JAX package's mesh render does, and as the
    analytic box, each within the pixel share."""
    from mj_envs_tpu.physics.model import GEOM_BOX
    for ascii_ in (False, True):
        path = str(tmp_path / f"cube{int(ascii_)}.stl")
        write_stl(path, cube_tris(1.0), ascii_)
        got, want = TM.load_stl(path, 0.5), JM.load_stl(path, 0.5)
        assert got[1].shape == (12, 3) and got[0].shape == (8, 3)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    verts, faces = got
    jp, tp = pixel_pair("hammer-v0")
    jm, s = jp.env.model, jp.env.spec
    rgba = np.array(jm.geom_rgba, np.float32)
    g = next(i for i in np.nonzero(np.asarray(s.geom_type) == GEOM_BOX)[0]
             if rgba[i, 3] > 0.05)
    xpos, xmat, _, _ = seeded_scene(jp.env, 1, B=1)
    size = np.asarray(jm.geom_size, np.float32)[g]
    mesh = [(verts * 2.0 * size[None, :], faces)]
    hidden = rgba.copy()
    hidden[g, 3] = 0.0
    inst_j = JR.MeshInstances(
        bank=JM.MeshBank.pack(mesh), meshid=np.array([0]),
        pos=jnp.asarray(xpos[0, g][None]), mat=jnp.asarray(xmat[0, g][None]),
        rgba=jnp.asarray(rgba[g][None]))
    # jitted: one compile instead of one per operation
    img_j = np.asarray(jax.jit(lambda c, p, r: JR.render(
        jm.replace(geom_rgba=c), p, r, jp.camera, meshes=inst_j))(
            jnp.asarray(hidden), xpos[0], xmat[0]))
    tm = tp.env.model
    inst_t = TR.MeshInstances(
        bank=TM.MeshBank.pack(mesh, device="cpu"), meshid=np.array([0]),
        pos=torch.as_tensor(xpos[:, g][:, None]),
        mat=torch.as_tensor(xmat[:, g][:, None]),
        rgba=torch.as_tensor(rgba[g][None]))
    args = (torch.as_tensor(xpos), torch.as_tensor(xmat), tp.camera)
    img_t = TR.render(tm.replace(geom_rgba=torch.as_tensor(hidden)), *args,
                      meshes=inst_t)[0].numpy()
    img_box = TR.render(tm, *args)[0].numpy()
    for other in (img_j, img_box):
        share = (np.abs(img_t - other).max(-1) > 1.0).mean()
        assert share <= PIXEL_SHARE, share
    assert np.abs(img_t - TR.render(tm.replace(geom_rgba=torch.as_tensor(
        hidden)), *args)[0].numpy()).max() > 10.0   # the mesh is drawn


# -- scenes and the golden image ----------------------------------------

def seeded_scene(jenv, seed, B=2):
    """B geom-pose sets from the JAX kinematics at qpos0 with the hinge and
    slide joints moved by N(0, 0.3), and per-env geom sizes (x U[0.8,
    1.2]) and colors with about a fifth of the geoms hidden (alpha 0)."""
    s, m = jenv.spec, jenv.model
    rng = np.random.default_rng(seed)
    q0 = np.asarray(m.qpos0, np.float32)
    moves = np.zeros(s.nq, bool)
    for j in range(s.njnt):
        if s.jnt_type[j] in (JNT_HINGE, JNT_SLIDE):
            moves[s.jnt_qposadr[j]] = True
    q = q0 + moves * rng.normal(0.0, 0.3, (B, s.nq)).astype(np.float32)
    # One pose at a time, through the jitted kinematics the pixel env's
    # constructor compiled already.
    kins = [jax.jit(JK.kinematics)(m, jnp.asarray(x)) for x in q]
    kin = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *kins)
    size = (np.asarray(m.geom_size, np.float32)
            * rng.uniform(0.8, 1.2, (B, s.ngeom, 1))).astype(np.float32)
    rgba = np.broadcast_to(np.asarray(m.geom_rgba, np.float32),
                           (B, s.ngeom, 4)).copy()
    rgba[..., 3] = np.where(rng.uniform(size=(B, s.ngeom)) < 0.2, 0.0,
                            rgba[..., 3])
    return np.array(kin.geom_xpos), np.array(kin.geom_xmat), size, rgba


def test_golden_image_from_the_jax_reset():
    """`test_raster_golden_image`'s state: the JAX reset of PRNGKey(0)
    (its board height from the JAX package's `_reset_var` on the reset's
    key split, qpos0 and zero qvel from `make_data`, as `reset` builds
    them) set into the port, rendered 64x64 by the port's pixel env."""
    from mj_envs_tpu.physics.model import make_data
    jp, tp = pixel_pair("hammer-v0")
    jenv = jp.env
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    var_j = jenv._reset_var(jenv.base_var(), sub)
    d_j = make_data(jenv.model, dtype=jenv.dtype)
    env = tp.env
    st = env.reset(1, env.generator(0))
    var = st.var.__class__(**{
        f: torch.as_tensor(np.array(getattr(var_j, f)))[None]
        for f, _ in st.var.items()})
    st = env.set_physics_state(st.replace(var=var),
                               np.array(d_j.qpos)[None],
                               np.array(d_j.qvel)[None])
    img = tp._render(st)[0].numpy()
    golden = np.load(GOLDEN)
    assert img.shape == golden.shape == (64, 64, 3)
    assert np.abs(img - golden).max() < 2.0, np.abs(img - golden).max()


def test_resize_and_observation_match_jax():
    rng = np.random.default_rng(3)
    img = rng.uniform(0.0, 255.0, (2, 128, 128, 3)).astype(np.float32)
    want = jax.vmap(JR.resize_half)(jnp.asarray(img))
    got = TR.resize_half(torch.as_tensor(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    u8 = np.round(img[:, :64, :64]).astype(np.uint8)
    key = jax.random.PRNGKey(5)
    want = JR.images_to_observation(jnp.asarray(u8), 5, key=key)
    noise = np.array(jax.random.uniform(key, u8.shape))
    got = TR.images_to_observation(torch.as_tensor(u8), 5,
                                   noise=torch.as_tensor(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-7)
    plain = TR.images_to_observation(torch.as_tensor(u8), 5)
    assert float(plain.min()) >= -0.5 and float(plain.max()) < 0.5
