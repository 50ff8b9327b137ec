"""Photon-map overlay: the -DVISUALIZE_PHOTON_MAP analog.

Counterpart of cse168_raytracer_tpu/render/photon_viz.py:22-65, host
numpy on the port's camera_basis: stored photon positions are projected
through the camera (the inverse of eye_rays' image-plane mapping,
Camera.cpp:103-161) and splatted as dots over a rendered frame, global
map photons green, caustic map photons red (the reference instead adds
a small sphere per stored photon and renders again, Scene.cpp:405-409,
586-591).
"""

from __future__ import annotations

import numpy as np

from cse168_raytracer_tpu_torch.render.camera import Camera, camera_basis


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def project_points(cam: Camera, pts: np.ndarray, width: int,
                   height: int) -> tuple[np.ndarray, np.ndarray]:
    """World points -> integer pixel coords (x, y) with y = 0 the BOTTOM
    scanline (render_hdr's row convention). Returns (xy (N, 2) int64,
    visible (N,) bool)."""
    w_dir, u_dir, v_dir, top, right = camera_basis(cam, width, height)
    w_dir = _np(w_dir).astype(np.float64)
    u_dir = _np(u_dir).astype(np.float64)
    v_dir = _np(v_dir).astype(np.float64)
    top = float(top)
    right = float(right)
    left, bottom = -right, -top
    c = pts.astype(np.float64) - _np(cam.eye).astype(np.float64)
    z = c @ (-w_dir)                       # distance along the view dir
    vis = z > 1e-6
    zs = np.where(vis, z, 1.0)
    u = (c @ u_dir) / zs
    v = (c @ v_dir) / zs
    x = (u - left) / (right - left) * width - 0.5
    y = (v - bottom) / (top - bottom) * height - 0.5
    xi = np.round(x).astype(np.int64)
    yi = np.round(y).astype(np.int64)
    vis &= (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
    return np.stack([xi, yi], axis=1), vis


def photon_overlay(img_u8: np.ndarray, cam: Camera, maps, width: int,
                   height: int) -> np.ndarray:
    """Splat stored photons over a rendered uint8 frame (row 0 = the
    bottom). Global map green, caustic map red; folded rows (zero
    power) are skipped like never-stored photons."""
    out = np.array(img_u8, np.uint8, copy=True)
    for grid, color in ((maps.global_map, (40, 255, 40)),
                        (maps.caustic_map, (255, 40, 40))):
        if grid is None:
            continue
        n = int(grid.n_valid)
        pos = _np(grid.pos)[:n]
        live = _np(grid.power)[:n].sum(axis=1) > 0
        xy, vis = project_points(cam, pos[live], width, height)
        xy = xy[vis]
        out[xy[:, 1], xy[:, 0]] = np.asarray(color, np.uint8)
    return out
