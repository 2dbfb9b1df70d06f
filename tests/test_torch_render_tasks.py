"""Each task's pixel camera and whole images of the port
(`mj_envs_torch/envs/pixels.py`, `mj_envs_torch/render/raster.py`)
against the JAX package's, CPU:

* the camera of `PixelObservationEnv` (its median lookat, elevation,
  origin, rotation and focal length) at 1e-5;
* `render` of every task at 128x128 on the same geom poses (the JAX
  package's kinematics at seeded joint angles, as numpy), with per-env
  geom sizes and colors, some geoms hidden: at most 0.5 % of the pixels
  may differ by more than 1.0 (of 255), the share `tests/test_vision.py`
  allows a mesh against its analytic box.
"""
import numpy as np
import pytest
import torch

import jax

from mj_envs_tpu.render import raster as JR
from mj_envs_torch.render import raster as TR
from test_torch_render import PIXEL_SHARE, TASKS, pixel_pair, seeded_scene


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)    # six xdist workers share the CPU
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("task", TASKS)
def test_camera_matches_jax(task):
    jp, tp = pixel_pair(task)
    np.testing.assert_allclose(tp.stat_center, jp.stat_center, rtol=1e-5,
                               atol=1e-5)
    assert abs(tp.elevation - jp.elevation) <= 1e-5
    assert (tp.azimuth, tp.distance) == (jp.azimuth, jp.distance)
    np.testing.assert_allclose(tp.camera.origin.numpy(),
                               np.asarray(jp.camera.origin), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tp.camera.rot.numpy(),
                               np.asarray(jp.camera.rot), atol=1e-5)
    assert abs(tp.camera.focal_px - float(jp.camera.focal_px)) \
        <= 1e-5 * tp.camera.focal_px


def render_pair(task, seed):
    jp, tp = pixel_pair(task)
    xpos, xmat, size, rgba = seeded_scene(jp.env, seed)
    jm = jp.env.model
    img_j = jax.jit(jax.vmap(lambda p, r, sz, c: JR.render(
        jm.replace(geom_size=sz, geom_rgba=c), p, r, jp.camera)))(
            xpos, xmat, size, rgba)
    tm = tp.env.model.replace(geom_size=torch.as_tensor(size),
                              geom_rgba=torch.as_tensor(rgba))
    img_t = TR.render(tm, torch.as_tensor(xpos), torch.as_tensor(xmat),
                      tp.camera)
    return np.asarray(img_j), img_t


@pytest.mark.parametrize("task", TASKS)
def test_render_matches_jax(task):
    img_j, img_t = render_pair(task, 0)
    assert img_t.shape == (2, 128, 128, 3) and img_t.dtype == torch.float32
    assert float(img_t.min()) >= 0.0 and float(img_t.max()) <= 255.0
    diff = np.abs(img_t.numpy() - img_j).max(-1)
    assert (diff > 1.0).mean() <= PIXEL_SHARE, (diff > 1.0).mean()
    assert img_t.std() > 5.0                     # geometry and sky


