"""Interactive viewer: the counterpart of the GLUT window
(MiroWindow.{h,cpp}) and its OpenGL preview (Scene::openGL,
Scene.cpp:36-48).

Counterpart of cse168_raytracer_tpu/render/viewer.py. The reference
toggles between a rasterized preview and a full raytrace
(Camera::click, Camera.cpp:37-70). The port has no rasterizer: its
preview is a cheap render (width/4 x height/4, trace depth 1, shadows
off) upsampled by repetition; raytrace mode runs the configured render.

Controls as MiroWindow::keyboard/motion (MiroWindow.cpp:91-245):

  left-drag   orbit: rotate viewDir about camera-right and up
              (ANGFACT = 1 degree a pixel, MiroWindow.cpp:12,98-108)
  w / s       dolly along viewDir            (MiroWindow.cpp:222-231)
  a / d       truck along right = viewDir x up, unnormalized
                                             (MiroWindow.cpp:233-245)
  q / z       pedestal along up              (MiroWindow.cpp:234-243)
  + / -       move-speed scale x1.5 / /1.5   (MiroWindow.cpp:214-220)
  r / g       raytrace mode / preview mode   (MiroWindow.cpp:204-212)
  i           write the frame to miro_<time>.ppm (MiroWindow.cpp:160-177)
  m           print eye and view direction   (MiroWindow.cpp:246-252)
  escape      quit                           (MiroWindow.cpp:156-158)

matplotlib is the window system, imported only by main_loop, so batch
use never needs it; without it main_loop raises ImportError. The window
shows the frame top-down (row 0 of a frame is the bottom scanline).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from cse168_raytracer_tpu_torch.config import RenderConfig
from cse168_raytracer_tpu_torch.core.vecmath import (cross, rotate_about_axis,
                                                     safe_normalize)
from cse168_raytracer_tpu_torch.render.camera import Camera
from cse168_raytracer_tpu_torch.render.image_io import write_ppm
from cse168_raytracer_tpu_torch.render.integrator import render_hdr
from cse168_raytracer_tpu_torch.render.tonemap import to_bytes, tonemap

ANGFACT = 1.0          # degrees per pixel of mouse drag (MiroWindow.cpp:12)
PREVIEW_SCALE = 4      # the preview renders at width/4 x height/4


@dataclasses.dataclass
class ViewerState:
    """Mutable interaction state (m_scaleFact etc., MiroWindow.h)."""
    cam: Camera
    raytrace: bool = False       # False: preview mode
    scale_fact: float = 1.0      # m_scaleFact
    mouse_xy: Optional[tuple[float, float]] = None
    frame: Optional[np.ndarray] = None   # the last uint8 frame


class InteractiveViewer:
    """Camera::click and the MiroWindow event loop over render_hdr."""

    def __init__(self, scene, static, cam: Camera, cfg: RenderConfig,
                 seed: int = 0, tonemap_kind: str = "sigmoid"):
        self.scene = scene
        self.static = static
        self.cfg = cfg.replace(seed=seed)
        self.tonemap_kind = tonemap_kind
        self.state = ViewerState(cam=cam)
        self.preview_cfg = self.cfg.replace(
            width=max(cfg.width // PREVIEW_SCALE, 16),
            height=max(cfg.height // PREVIEW_SCALE, 16),
            trace_depth=1, trace_samples=1, path_tracing=False,
            disable_shadows=True)

    @torch.no_grad()
    def render_frame(self) -> np.ndarray:
        """One frame at the current camera: uint8 (H, W, 3)."""
        cfg = self.cfg if self.state.raytrace else self.preview_cfg
        hdr, _stats = render_hdr(self.scene, self.static, self.state.cam,
                                 cfg)
        rgb8 = to_bytes(tonemap(hdr, self.tonemap_kind)).cpu().numpy()
        if not self.state.raytrace and rgb8.shape[0] != self.cfg.height:
            rgb8 = np.repeat(np.repeat(rgb8, PREVIEW_SCALE, 0),
                             PREVIEW_SCALE, 1)
            rgb8 = rgb8[:self.cfg.height, :self.cfg.width]
        self.state.frame = rgb8
        return rgb8

    def _move(self, delta: torch.Tensor) -> None:
        cam = self.state.cam
        self.state.cam = dataclasses.replace(cam, eye=cam.eye + delta)

    def handle_key(self, key: str) -> bool:
        """Apply one key (MiroWindow::keyboard, MiroWindow.cpp:152-245);
        False on quit."""
        st = self.state
        cam = st.cam
        # the reference leaves vRight unnormalized (MiroWindow.cpp:233-245)
        right = cross(cam.view_dir, cam.up)
        k = key.lower() if len(key) == 1 else key
        if key in ("escape", "esc"):
            return False
        if k == "i":
            if st.frame is None:
                self.render_frame()
            write_ppm(f"miro_{int(time.time())}.ppm", st.frame)
        elif k in ("r", "g"):
            st.raytrace = k == "r"
        elif key == "+":
            st.scale_fact *= 1.5
        elif key == "-":
            st.scale_fact /= 1.5
        elif k in ("w", "s", "q", "z", "a", "d"):
            axis = {"w": cam.view_dir, "s": -cam.view_dir, "q": cam.up,
                    "z": -cam.up, "a": -right, "d": right}[k]
            self._move(st.scale_fact * axis)
        elif k == "m":
            print(f"Eye: {st.cam.eye.cpu().numpy()}")
            print(f"ViewDir: {st.cam.view_dir.cpu().numpy()}")
        return True

    def handle_drag(self, dx: float, dy: float) -> None:
        """Left-button orbit (MiroWindow::motion, MiroWindow.cpp:91-115):
        viewDir rotated about right, then about up."""
        cam = self.state.cam
        xfact = -ANGFACT * dy * math.pi / 180.0
        yfact = -ANGFACT * dx * math.pi / 180.0
        right = cross(cam.view_dir, cam.up)
        v = rotate_about_axis(cam.view_dir, xfact, right)
        v = rotate_about_axis(v, yfact, cam.up)
        self.state.cam = dataclasses.replace(cam, view_dir=safe_normalize(v))

    def main_loop(self) -> None:
        """Open a matplotlib window and run its event loop
        (MiroWindow::mainLoop, MiroWindow.cpp:63-78)."""
        try:
            import matplotlib.pyplot as plt
        except ImportError as e:
            raise ImportError("the interactive window needs matplotlib, "
                              "which is not installed") from e

        fig, ax = plt.subplots(figsize=(8, 8 * self.cfg.height
                                        / max(self.cfg.width, 1)))
        ax.set_axis_off()
        im = ax.imshow(self.render_frame()[::-1])
        fig.canvas.manager.set_window_title("miro-tpu-torch")

        def redraw():
            im.set_data(self.render_frame()[::-1])
            fig.canvas.draw_idle()

        def on_key(event):
            if event.key is None:
                return
            if not self.handle_key(event.key):
                plt.close(fig)
                return
            redraw()

        def on_press(event):
            if event.button == 1:
                self.state.mouse_xy = (event.x, event.y)

        def on_release(event):
            self.state.mouse_xy = None

        def on_motion(event):
            if self.state.mouse_xy is None or event.x is None:
                return
            x0, y0 = self.state.mouse_xy
            self.handle_drag(event.x - x0, -(event.y - y0))
            self.state.mouse_xy = (event.x, event.y)
            redraw()

        fig.canvas.mpl_connect("key_press_event", on_key)
        fig.canvas.mpl_connect("button_press_event", on_press)
        fig.canvas.mpl_connect("button_release_event", on_release)
        fig.canvas.mpl_connect("motion_notify_event", on_motion)
        plt.show()
