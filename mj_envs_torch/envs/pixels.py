"""Pixel observations of the PyTorch port (`mj_envs_tpu/envs/pixels.py`),
the "mj_envs_vision" variants.

The reference chain (`headless_observer.py` and `utils/wrappers.py`
`CustomPixelObservationWrapper:32-76`): a free camera with azimuth 90,
distance 4.5 and an elevation computed from the vector between a task
body and the last model camera (`set_view 'default'`, `:59-67`),
rendered offscreen, center-cropped to 128x128 and resized to 64x64.  The
wrapper keeps both the state vector and the pixels (`get_state` /
`get_pixels`, `wrappers.py:72-76`).

The camera set-up keeps the reference's observable quirks, as the JAX
package does:
* the lookat point is mujoco-py's `MjRenderContext._init_camera` per-axis
  median of `geom_xpos` at qpos0 (not the bounding-box center, which
  hammer's far occluder wall drags away);
* hammer's observer is built before its names resolve, so its elevation
  body is the last body; door, pen and relocate use body 0 (the world);
* elevation = -45 + deg(arccos(lookat_x / lookat_z)) / 2.

The camera and its 128x128 ray directions are computed once, on the CPU
in float32 as the JAX package computes them, and used on the env's
device.

Batch-first: a `PixelEnvState` holds B envs, pixels (B, H, W, 3) float32
in [0, 255]; rendering goes over the envs in chunks (RENDER_CHUNK
unless the caller sets it, as pixel PPO does from its `pixel_chunk`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .base import AdroitEnv, EnvState, _apply_var
from ..render import raster
from ..utils import quatmath as Q

RENDER_CHUNK = 256


@dataclasses.dataclass
class PixelEnvState:
    state: EnvState
    pixels: torch.Tensor      # (B, H, W, 3) float32 in [0, 255]


class PixelObservationEnv:
    """Pixel-observation wrapper over an AdroitEnv on the env's device."""

    def __init__(self, env: AdroitEnv, height: int = 64, width: int = 64):
        from ..physics.kinematics import kinematics_plain
        self.env = env
        self.height = height
        self.width = width
        s = env.spec
        # The camera is set up on the CPU in float32 whatever the env's
        # device, so that every device renders from the same camera.
        m = env.model.to("cpu", torch.float32)
        kin = kinematics_plain(m, m.qpos0[None])
        gx = kin.geom_xpos[0].float().cpu().numpy()
        self.stat_center = np.median(gx, axis=0)
        self.lookat_bid = s.nbody - 1 if env.TASK == "hammer" else 0
        # The reference's cam_xpos[-1]: the last model camera's position.
        self.cam_pos_last = np.zeros(3, np.float32)
        xpos = kin.xpos[0].float().cpu()
        if s.ncam > 0:
            cb = int(s.cam_bodyid[s.ncam - 1])
            rot = Q.quat2mat(kin.xquat[0, cb].float().cpu()).numpy()
            off = m.cam_pos[s.ncam - 1].float().cpu().numpy()
            self.cam_pos_last = xpos[cb].numpy() + rot @ off
        lookatv = xpos[self.lookat_bid].numpy() - self.cam_pos_last
        ratio = np.clip(lookatv[0] / lookatv[2] if lookatv[2] != 0 else 0.0,
                        -1.0, 1.0)
        self.elevation = -45.0 + np.degrees(np.arccos(ratio)) / 2.0
        self.azimuth = 90.0
        self.distance = 4.5
        self.camera = raster.free_camera(
            self.stat_center, self.azimuth, self.elevation, self.distance,
            fovy_deg=45.0, height_px=480, device=env.device)
        self.dirs = raster.camera_rays(self.camera, 128, 128, env.device)

    def _render_one(self, state: EnvState) -> torch.Tensor:
        model = _apply_var(self.env.model, state.var)
        img = raster.render(model, state.data.geom_xpos,
                            state.data.geom_xmat, self.camera, 128, 128,
                            dirs=self.dirs)
        return raster.resize_half(img) if self.height == 64 else img

    def _render(self, state: EnvState, chunk: int = RENDER_CHUNK
                ) -> torch.Tensor:
        """(B, H, W, 3) float32 in [0, 255], `chunk` envs at a time."""
        B, c = state.batch, chunk
        if c <= 0 or B <= c:
            return self._render_one(state)
        return torch.cat([self._render_one(state.map(lambda x: x[i:i + c]))
                          for i in range(0, B, c)])

    def reset(self, num_envs: int, generator: torch.Generator
              ) -> PixelEnvState:
        st = self.env.reset(num_envs, generator)
        return PixelEnvState(state=st, pixels=self._render(st))

    def step(self, pstate: PixelEnvState, action: torch.Tensor,
             generator: torch.Generator) -> PixelEnvState:
        """Auto-reset step; the pixels of the returned state (a fresh
        episode's first frame at a boundary)."""
        st = self.env.step_auto_reset(pstate.state, action, generator)
        return PixelEnvState(state=st, pixels=self._render(st))

    # the reference wrapper's accessors (wrappers.py:72-76)
    def get_pixels(self, pstate: PixelEnvState) -> torch.Tensor:
        return pstate.pixels

    def get_state(self, pstate: PixelEnvState) -> torch.Tensor:
        return pstate.state.obs
