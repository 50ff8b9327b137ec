"""Pinhole camera as a batched ray generator.

Counterpart of cse168_raytracer_tpu/render/camera.py (Camera::eyeRay,
Camera.cpp:103-161). The port covers the deterministic pinhole rays
through pixel centres; jittered and thin-lens (DOF) rays come with
ROADMAP item A11.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cse168_raytracer_tpu_torch.config import PI
from cse168_raytracer_tpu_torch.core.vecmath import cross, safe_normalize

DEG_TO_RAD = PI / 180.0
HALF_DEG_TO_RAD = DEG_TO_RAD / 2.0  # Camera.cpp:15


@dataclasses.dataclass
class Camera:
    eye: torch.Tensor       # (3,)
    view_dir: torch.Tensor  # (3,) unit (Camera.h:94-95)
    up: torch.Tensor        # (3,)
    fov: torch.Tensor       # () degrees
    bg_color: torch.Tensor  # (3,)


def camera_from_arrays(eye, view_dir, up, fov, bg_color,
                       device="cpu") -> Camera:
    t = lambda x: torch.as_tensor(np.array(x, np.float32), device=device)
    return Camera(eye=t(eye), view_dir=t(view_dir), up=t(up), fov=t(fov),
                  bg_color=t(bg_color))


def make_camera(eye, look_at, up=(0.0, 1.0, 0.0), fov=45.0,
                bg_color=(0.0, 0.0, 0.0), device="cpu") -> Camera:
    eye = np.asarray(eye, np.float32)
    vd = safe_normalize(torch.as_tensor(np.asarray(look_at, np.float32)
                                        - eye))
    return camera_from_arrays(eye, vd, up, fov, bg_color, device)


def camera_basis(cam: Camera, width: int, height: int):
    """Image-plane basis and extents (Camera.cpp:113-124)."""
    w_dir = safe_normalize(-cam.view_dir)
    u_dir = safe_normalize(cross(cam.up, w_dir))
    v_dir = cross(w_dir, u_dir)
    aspect = width / height
    # tan on the host: the CPU's and the card's tanf may differ by an ulp
    top = torch.tan(cam.fov.cpu() * HALF_DEG_TO_RAD).to(cam.fov.device)
    right = aspect * top
    return w_dir, u_dir, v_dir, top, right


def eye_rays(cam: Camera, x: torch.Tensor, y: torch.Tensor, width: int,
             height: int):
    """One pinhole ray through the centre of each (x, y) pixel (any
    shape; Camera.cpp:127,157-158). Returns (origins, unit directions)."""
    w_dir, u_dir, v_dir, top, right = camera_basis(cam, width, height)
    left, bottom = -right, -top
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    u = left + (right - left) * ((xf + 0.5) / width)
    v = bottom + (top - bottom) * ((yf + 0.5) / height)
    o = cam.eye.expand(x.shape + (3,))
    d = safe_normalize(u[..., None] * u_dir + v[..., None] * v_dir - w_dir)
    return o, d
