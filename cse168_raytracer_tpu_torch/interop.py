"""Carry the JAX package's scenes and cameras over to the port.

The functions take the JAX package's Scene, SceneStatic and Camera with
their array leaves already converted to numpy (for example
`jax.tree.map(np.asarray, scene)` on the caller's side) and build the
port's counterparts on `device`, so both packages render the very same
inputs. This module reads attributes only and imports no JAX. An
attached accelerator is not carried over: call ops.accel.attach_accel
on the result.
"""

from __future__ import annotations

import numpy as np
import torch

from cse168_raytracer_tpu_torch.config import resolve_device
from cse168_raytracer_tpu_torch.models.geometry import (BLPatchPool,
                                                        PlanePool, SpherePool,
                                                        TrianglePack)
from cse168_raytracer_tpu_torch.models.lights import light_table_from_arrays
from cse168_raytracer_tpu_torch.models.materials import MaterialTable
from cse168_raytracer_tpu_torch.models.scene import Scene, SceneStatic
from cse168_raytracer_tpu_torch.models.textures import (CellularTexture,
                                                        Environment,
                                                        ImageTexture)
from cse168_raytracer_tpu_torch.ops.photon import PhotonGrid, PhotonMaps
from cse168_raytracer_tpu_torch.render.camera import (Camera,
                                                      camera_from_arrays)


def _t(x, device, dtype=None):
    return torch.as_tensor(np.array(x, dtype=dtype), device=device)


def _fields(obj, names, device):
    return {k: _t(getattr(obj, k), device) for k in names}


def _image(tex, device) -> ImageTexture:
    return ImageTexture(image=_t(tex.image, device),
                        lowres=_t(tex.lowres, device),
                        max_intensity=_t(tex.max_intensity, device),
                        is_hdr=bool(tex.is_hdr))


def scene_from_numpy(scene, static, device=None):
    """(Scene, SceneStatic) of the port from the JAX package's scene and
    static facts with numpy leaves: geometry, materials, lights, the
    environment (its image map too), image and cellular textures, and
    the photon maps (both grids and their coarse levels, every field
    as written) and the bilinear patches."""
    device = resolve_device(device)

    n_valid = lambda pool: int(np.asarray(pool.valid).sum())
    tp = scene.tris
    pack = TrianglePack(
        **_fields(tp, ("v0", "e1", "e2", "n_geo", "n0", "n1", "n2",
                       "t0", "t1", "t2", "has_uv", "material_id", "valid"),
                  device),
        w6=None if tp.w6 is None else _t(tp.w6, device),
        w4=None if tp.w4 is None else _t(tp.w4, device),
        n_valid=n_valid(tp))
    pool_f = ("material_id", "valid")
    spheres = SpherePool(**_fields(scene.spheres, ("center", "radius")
                                   + pool_f, device),
                         n_valid=n_valid(scene.spheres))
    planes = PlanePool(**_fields(scene.planes, ("origin", "normal") + pool_f,
                                 device), n_valid=n_valid(scene.planes))
    materials = MaterialTable(**_fields(
        scene.materials, ("kd", "ks", "kt", "shininess", "ior",
                          "texture_kind", "texture_params",
                          "texture_color2", "image_id"), device))
    lt = scene.lights
    lights = light_table_from_arrays(lt.kind, lt.position, lt.normal,
                                     lt.color, lt.wattage, lt.radius,
                                     lt.dims, device)
    env = scene.env
    environment = Environment(
        image=None if env.image is None else _image(env.image, device),
        cloud_params=(None if env.cloud_params is None
                      else _t(env.cloud_params, device)),
        rotation=_t(env.rotation, device), bg_color=_t(env.bg_color, device),
        quirk_cloud_env_black=bool(env.quirk_cloud_env_black))
    cellulars = tuple(
        CellularTexture(points=_t(c.points, device), valid=_t(c.valid, device),
                        halo=int(c.halo)) for c in scene.cellulars)
    photons = None
    if getattr(scene, "photons", None) is not None:
        photons = PhotonMaps(
            global_map=photon_grid_from_numpy(scene.photons.global_map,
                                              device),
            caustic_map=photon_grid_from_numpy(scene.photons.caustic_map,
                                               device))
    blpatches = None
    if getattr(scene, "blpatches", None) is not None:
        blpatches = BLPatchPool(**_fields(
            scene.blpatches, ("p00", "p10", "p01", "p11") + pool_f, device))
    port_scene = Scene(tris=pack, spheres=spheres, planes=planes,
                       materials=materials, lights=lights, env=environment,
                       images=tuple(_image(i, device) for i in scene.images),
                       cellulars=cellulars, photons=photons,
                       blpatches=blpatches)
    port_static = SceneStatic(
        texture_kinds=tuple(int(k) for k in static.texture_kinds),
        any_bump=bool(static.any_bump), num_lights=int(static.num_lights),
        any_refractive=bool(static.any_refractive),
        any_reflective=bool(static.any_reflective))
    return port_scene, port_static


def photon_grid_from_numpy(grid, device=None):
    """The port's PhotonGrid (or None) from the JAX package's, numpy
    leaves, its coarse level too."""
    if grid is None:
        return None
    device = resolve_device(device)
    return PhotonGrid(
        **_fields(grid, ("pos", "power", "dir", "weight", "cell_hash",
                         "radius"), device),
        n_valid=int(np.asarray(grid.n_valid)), table_size=int(grid.table_size),
        max_per_cell=int(grid.max_per_cell), knn=int(grid.knn),
        coarse=photon_grid_from_numpy(grid.coarse, device))


def camera_from_numpy(cam, device=None) -> Camera:
    """The port's Camera from the JAX package's camera (numpy leaves)."""
    device = resolve_device(device)
    return camera_from_arrays(cam.eye, cam.view_dir, cam.up, cam.fov,
                              cam.bg_color, device)
