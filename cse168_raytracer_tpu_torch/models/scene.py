"""Scene container and its static facts.

Counterpart of cse168_raytracer_tpu/models/scene.py: the geometry
pools, material and light tables, environment, image textures,
cellular textures, the photon maps (ops/photon.py) and the bilinear
patches (JAX models/scene.py:48-49,72,89) in one dataclass, plus
`SceneStatic`, the host-known facts that select code paths (texture
kinds present, bump maps, light count, reflective / refractive
materials).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Sequence, Tuple

import torch

from cse168_raytracer_tpu_torch.config import resolve_device
from cse168_raytracer_tpu_torch.models.geometry import (BLPatchPool,
                                                        PlanePool, SpherePool,
                                                        TrianglePack,
                                                        empty_plane_pool,
                                                        empty_sphere_pool,
                                                        empty_triangle_pack)
from cse168_raytracer_tpu_torch.models.lights import (LightTable,
                                                      make_light_table)
from cse168_raytracer_tpu_torch.models.materials import (MaterialBuilder,
                                                         MaterialTable)
from cse168_raytracer_tpu_torch.models.textures import (CellularTexture,
                                                        Environment,
                                                        ImageTexture,
                                                        active_kinds,
                                                        has_bump,
                                                        make_environment)
from cse168_raytracer_tpu_torch.utils import profiling

if TYPE_CHECKING:
    from cse168_raytracer_tpu_torch.ops.photon import PhotonMaps


@dataclasses.dataclass
class Scene:
    """All traced scene data; `accel` is attached by ops/accel.py."""
    tris: TrianglePack
    spheres: SpherePool
    planes: PlanePool
    materials: MaterialTable
    lights: LightTable
    env: Environment
    images: Tuple[ImageTexture, ...] = ()
    # cellular point-set textures (CellularTexture2D, Texture.h:84-99)
    cellulars: Tuple[CellularTexture, ...] = ()
    accel: Optional[object] = None
    # photon grids (global, caustic) built by ops/photon.py, or None
    photons: Optional["PhotonMaps"] = None
    # bilinear patches, traced after the planes, or None
    blpatches: Optional[BLPatchPool] = None

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.tris.v0.device


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Host-known scene facts that select code paths."""
    texture_kinds: tuple
    any_bump: bool
    num_lights: int
    any_refractive: bool
    any_reflective: bool


def make_static(materials: MaterialTable, lights: LightTable) -> SceneStatic:
    return SceneStatic(
        texture_kinds=active_kinds(materials),
        any_bump=has_bump(materials),
        num_lights=int(lights.num_lights),
        any_refractive=bool((materials.kt > 0).any()),
        any_reflective=bool((materials.ks > 0).any()))


@profiling.phase("scene.build")
def make_scene(tris: Optional[TrianglePack] = None,
               spheres: Optional[SpherePool] = None,
               planes: Optional[PlanePool] = None,
               materials: Optional[MaterialTable] = None,
               lights: Optional[Sequence[dict]] = None,
               env: Optional[Environment] = None,
               images: Sequence[ImageTexture] = (),
               cellulars: Sequence[CellularTexture] = (),
               blpatches: Optional[BLPatchPool] = None,
               device=None) -> tuple[Scene, SceneStatic]:
    device = resolve_device(device)
    if tris is None:
        tris = empty_triangle_pack(device=device)
    if spheres is None:
        spheres = empty_sphere_pool(device)
    if planes is None:
        planes = empty_plane_pool(device)
    if materials is None:
        materials = MaterialBuilder().build(device)
    light_table = (lights if isinstance(lights, LightTable)
                   else make_light_table(list(lights or []), device))
    if env is None:
        env = make_environment(device=device)
    scene = Scene(tris=tris, spheres=spheres, planes=planes,
                  materials=materials, lights=light_table, env=env,
                  images=tuple(images), cellulars=tuple(cellulars),
                  blpatches=blpatches)
    return scene, make_static(materials, light_table)
