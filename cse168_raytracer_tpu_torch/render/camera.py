"""Pinhole and thin-lens camera as a batched ray generator.

Counterpart of cse168_raytracer_tpu/render/camera.py:41-92 (Camera::
eyeRay, Camera.cpp:103-161): rays through pixel centres, or jittered
within the pixel, and the thin lens of -DDOF (Camera.cpp:135-148): the
eye moves to a uniform point of the aperture disc and the ray is
re-aimed at the focus plane. `eye_rays` takes its uniforms explicitly;
`draw_eye_rays` draws them from a generator.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cse168_raytracer_tpu_torch.config import PI, resolve_device
from cse168_raytracer_tpu_torch.core.sampling import uniform, uniform_disc
from cse168_raytracer_tpu_torch.core.vecmath import (cross, div_scalar,
                                                     safe_normalize)
from cse168_raytracer_tpu_torch.utils import profiling

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
                       device=None) -> Camera:
    device = resolve_device(device)
    t = lambda x: torch.as_tensor(np.array(x, np.float32), device=device)
    return Camera(eye=t(eye), view_dir=t(view_dir), up=t(up), fov=t(fov),
                  bg_color=t(bg_color))


def make_camera(eye, look_at, up=(0.0, 1.0, 0.0), fov=45.0,
                bg_color=(0.0, 0.0, 0.0), device=None) -> Camera:
    device = resolve_device(device)
    eye = np.asarray(eye, np.float32)
    vd = safe_normalize(torch.as_tensor(np.asarray(look_at, np.float32)
                                        - eye))
    return camera_from_arrays(eye, vd, up, fov, bg_color, device)


def camera_basis(cam: Camera, width: int, height: int):
    """Image-plane basis and extents (Camera.cpp:113-124): (w_dir, u_dir,
    v_dir, top, right). A renderer computes it once a frame, before its
    first launch, and hands it to every eye_rays of the frame."""
    w_dir = safe_normalize(-cam.view_dir)
    u_dir = safe_normalize(cross(cam.up, w_dir))
    v_dir = cross(w_dir, u_dir)
    aspect = width / height
    # tan on the host: no device rounds tanf correctly and the card's may
    # differ from the CPU's by an ulp; the rest of the camera is
    # device-stable (core/vecmath.py: sqrt_rn, and div_scalar below)
    # (on the card the copy there and back blocks the host twice)
    with profiling.sync("camera_fov", cam.fov, n=2):
        top = torch.tan(cam.fov.cpu() * HALF_DEG_TO_RAD).to(cam.fov.device)
    right = aspect * top
    return w_dir, u_dir, v_dir, top, right


def eye_rays(cam: Camera, x: torch.Tensor, y: torch.Tensor, width: int,
             height: int, jitter: torch.Tensor | None = None,
             lens: torch.Tensor | None = None, dof_aperture: float = 0.0,
             dof_focus: float = 0.0, basis: tuple | None = None):
    """One ray per (x, y) pixel (any shape; Camera.cpp:127,157-158):
    through the pixel centre, or at the offset jitter (..., 2) in [0, 1)
    within the pixel. dof_aperture > 0 needs lens (..., 2) uniforms: the
    eye moves to uniform_disc(lens, dof_aperture) in the image plane's
    basis and the ray aims at the point the pixel ray through the
    original eye meets at dof_focus along the view direction
    (Camera.cpp:135-148). basis is camera_basis(cam, width, height),
    computed here when not given. Returns (origins, unit directions)."""
    if basis is None:
        basis = camera_basis(cam, width, height)
    w_dir, u_dir, v_dir, top, right = basis
    left, bottom = -right, -top
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    dx, dy = (0.5, 0.5) if jitter is None else (jitter[..., 0],
                                                jitter[..., 1])
    u = left + (right - left) * div_scalar(xf + dx, width)
    v = bottom + (top - bottom) * div_scalar(yf + dy, height)
    if dof_aperture > 0.0:
        if lens is None:
            raise ValueError("a thin-lens ray needs lens uniforms")
        disc = uniform_disc(lens, dof_aperture)
        o = cam.eye + disc[..., 0:1] * u_dir + disc[..., 1:2] * v_dir
        focus = cam.eye + cam.view_dir * dof_focus
        local_w = safe_normalize(-(focus - o))
    else:
        o = cam.eye.expand(x.shape + (3,))
        local_w = w_dir
    d = safe_normalize(u[..., None] * u_dir + v[..., None] * v_dir - local_w)
    return o, d


def draw_eye_rays(cam: Camera, x: torch.Tensor, y: torch.Tensor,
                  width: int, height: int, gen: torch.Generator,
                  dof_aperture: float = 0.0, dof_focus: float = 0.0,
                  basis: tuple | None = None):
    """eye_rays jittered within each pixel, and through the thin lens
    when dof_aperture > 0, with uniforms drawn from gen: the jitter,
    then the lens."""
    shape = x.shape + (2,)
    jitter = uniform(gen, shape, x.device)
    lens = uniform(gen, shape, x.device) if dof_aperture > 0.0 else None
    return eye_rays(cam, x, y, width, height, jitter, lens, dof_aperture,
                    dof_focus, basis)
