"""Interactive policy viewer of the PyTorch port (`mj_envs_tpu/viewer.py`;
the reference's `MjViewer` windowed mode).

The reference opens a GLFW window per env with a per-task free camera
(`mj_viewer_setup`: hammer az=45 dist=2.0, door az=90 dist=1.5, pen
az=-45 dist=1.0, relocate az=90 dist=1.5 --
`mj_envs_vision/hand_manipulation_suite/hammer_v0.py:155-159`,
`door_v0.py:140-144`, `pen_v0.py:154-158`, `relocate_v0.py:131-136`)
and drives it from `utils/visualize_env.py:75-104` (`visualise_policy`,
with the zero-action warm-up).

Here the frames come from the port's ray-caster (`render/raster.py`) on
the env's device, shown in a matplotlib window with MjViewer-style
keyboard control:

    arrows       rotate (azimuth / elevation)
    + / -        zoom (distance)
    space        pause / resume
    r            reset the episode
    q / escape   close

Headless: with the Agg backend, or with no matplotlib installed and no
backend asked for, `run()` steps and renders without a window and never
blocks.

CLI:  python -m mj_envs_torch.viewer --env_name hammer-v0 \\
          [--policy ckpt.pt|dapg.pickle] [--episodes 2] [--device cuda]
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional

import numpy as np
import torch

from . import envs
from .envs.base import _apply_var
from .render import raster

# Reference per-task free-camera setups (azimuth_deg, distance).
# MjViewer leaves elevation at mujoco's free-camera default (-45 deg).
VIEWER_CAMS = {
    "hammer": (45.0, 2.0),
    "door": (90.0, 1.5),
    "pen": (-45.0, 1.0),
    "relocate": (90.0, 1.5),
}
DEFAULT_ELEVATION = -45.0


def _pyplot(backend: Optional[str]):
    """matplotlib.pyplot for a window, or None for a headless viewer
    (backend Agg, or no matplotlib and no backend asked for)."""
    if backend is not None and backend.lower() == "agg":
        return None
    try:
        import matplotlib
    except ImportError:
        if backend is not None:
            raise
        return None
    if backend:
        matplotlib.use(backend)
    import matplotlib.pyplot as plt
    return plt


class InteractiveViewer:
    """Windowed (or headless) single-env rollout viewer on `device` (the
    card unless the caller asks for the CPU)."""

    def __init__(self, env_name: str,
                 policy: Optional[Callable] = None,
                 height: int = 240, width: int = 320,
                 backend: Optional[str] = None,
                 warmup_steps: int = 0, seed: int = 0, device="cuda"):
        self._plt = _pyplot(backend)

        self.env = envs.make(env_name, device=device)
        task = self.env.TASK
        self.azimuth, self.distance = VIEWER_CAMS.get(task, (90.0, 2.0))
        self.elevation = DEFAULT_ELEVATION
        self.height, self.width = height, width
        self.policy = policy
        self.warmup_steps = warmup_steps
        self.paused = False
        self.closed = False
        self._gen = self.env.generator(seed)

        # Camera lookat: the median of the geom positions at the first
        # reset (mujoco-py's _init_camera convention, as envs/pixels.py;
        # mjStatistic.center points at hammer's far wall).
        st = self.env.reset(1, self._gen)
        self.lookat = np.median(st.data.geom_xpos[0].cpu().numpy(), axis=0)
        self.state = st
        # The first reset's model fields render every frame, as the JAX
        # viewer's.
        self._model = _apply_var(self.env.model, st.var)
        self.fig = None
        self._im = None

    # -- camera ----------------------------------------------------------

    def _camera(self):
        return raster.free_camera(self.lookat, self.azimuth,
                                  self.elevation, self.distance,
                                  fovy_deg=45.0, height_px=self.height,
                                  device=self.env.device)

    def handle_key(self, key: str) -> None:
        """MjViewer-style controls; usable directly (tests) or from the
        matplotlib key_press_event."""
        if key == "left":
            self.azimuth -= 10.0
        elif key == "right":
            self.azimuth += 10.0
        elif key == "up":
            self.elevation = min(self.elevation + 10.0, 89.0)
        elif key == "down":
            self.elevation = max(self.elevation - 10.0, -89.0)
        elif key in ("+", "="):
            self.distance = max(0.2, self.distance * 0.8)
        elif key == "-":
            self.distance = min(20.0, self.distance * 1.25)
        elif key == " ":
            self.paused = not self.paused
        elif key == "r":
            self.state = self.env.reset(1, self._gen)
        elif key in ("q", "escape"):
            self.closed = True

    # -- stepping --------------------------------------------------------

    def _action(self, t: int) -> torch.Tensor:
        # The reference visualise_policy warm-up: zero actions for the
        # first `warmup_steps` (`visualize_env.py:85-93`).
        if t < self.warmup_steps or self.policy is None:
            return torch.zeros((1, self.env.nu), dtype=self.env.dtype,
                               device=self.env.device)
        return self.policy(self.state.obs).to(self.env.dtype)

    @torch.no_grad()
    def frame(self) -> np.ndarray:
        """Render the current state with the current camera -> (H, W, 3)
        uint8 (rounded)."""
        img = raster.render(self._model, self.state.data.geom_xpos,
                            self.state.data.geom_xmat, self._camera(),
                            height=self.height, width=self.width)
        return torch.round(img[0]).to(torch.uint8).cpu().numpy()

    @torch.no_grad()
    def run(self, episodes: int = 2, max_steps: Optional[int] = None,
            fps: float = 25.0) -> float:
        """Roll `episodes` episodes; returns the last episode's score.
        Headless (no window) this never blocks."""
        plt = self._plt
        interactive = plt is not None and \
            plt.get_backend().lower() != "agg"
        if interactive and self.fig is None:
            self.fig, ax = plt.subplots(
                figsize=(self.width / 80, self.height / 80))
            ax.set_axis_off()
            self._im = ax.imshow(self.frame())
            self.fig.canvas.mpl_connect(
                "key_press_event", lambda ev: self.handle_key(ev.key))
            plt.show(block=False)

        score = 0.0
        cap = max_steps or self.env.MAX_EPISODE_STEPS
        for _ in range(episodes):
            score, t = 0.0, 0
            while t < cap and not self.closed:
                if not self.paused:
                    self.state = self.env.step_auto_reset(
                        self.state, self._action(t), self._gen)
                    score += float(self.state.reward[0])
                    t += 1
                if interactive:
                    self._im.set_data(self.frame())
                    self.fig.canvas.draw_idle()
                    plt.pause(max(1e-3, 1.0 / fps))
            print(f"Episode score = {score}", flush=True)
            if self.closed:
                break
            self.handle_key("r")
        if interactive and self.fig is not None:
            plt.close(self.fig)
        return score


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--env_name", required=True)
    ap.add_argument("--policy", default=None,
                    help="checkpoint (.pt) or DAPG pickle; zero actions if "
                         "omitted")
    ap.add_argument("--episodes", type=int, default=2)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--backend", default=None,
                    help="matplotlib backend override (e.g. Agg)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    policy = None
    if args.policy:
        from .visualize import _load_policy
        env = envs.make(args.env_name, device=args.device)
        policy, kind = _load_policy(args.policy, env, env.TASK)
        print(f"loaded {kind} policy from {args.policy}", flush=True)
    v = InteractiveViewer(args.env_name, policy=policy,
                          backend=args.backend, device=args.device)
    v.run(episodes=args.episodes, max_steps=args.max_steps)


if __name__ == "__main__":
    main()
