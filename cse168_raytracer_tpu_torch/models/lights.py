"""Light table and next-event-estimation geometry.

Counterpart of cse168_raytracer_tpu/models/lights.py:51,137. The port
covers point lights (PointLight.h:8-63): the origin is the position and
the NEE falloff is 1/(4 pi^2 r^2) (Phong.cpp:140). Square and
directional-area lights need random origins and come with ROADMAP item
A11 (path tracing and DOF).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cse168_raytracer_tpu_torch.config import PI
from cse168_raytracer_tpu_torch.core.vecmath import dot

LIGHT_POINT = 0
LIGHT_SQUARE = 1
LIGHT_DIRECTIONAL_AREA = 2


@dataclasses.dataclass
class LightTable:
    kind: torch.Tensor      # (L,) int32
    position: torch.Tensor  # (L, 3)
    normal: torch.Tensor    # (L, 3) unit (square / directional)
    color: torch.Tensor     # (L, 3)
    wattage: torch.Tensor   # (L,)
    radius: torch.Tensor    # (L,) disc radius (directional-area)
    dims: torch.Tensor      # (L, 2) width / height (square)
    kinds: tuple            # host copy of `kind`, for static dispatch

    @property
    def num_lights(self) -> int:
        return self.kind.shape[0]


def make_light_table(lights: list[dict], device="cpu") -> LightTable:
    """lights: dicts with kind/position/color/wattage and optional
    normal/radius/dims."""
    n = max(len(lights), 1)
    kind = np.zeros(n, np.int32)
    pos = np.zeros((n, 3), np.float32)
    nrm = np.tile(np.array([0, 1, 0], np.float32), (n, 1))
    col = np.zeros((n, 3), np.float32)
    wat = np.zeros(n, np.float32)
    rad = np.ones(n, np.float32)
    dim = np.ones((n, 2), np.float32)
    for i, l in enumerate(lights):
        kind[i] = l["kind"]
        pos[i] = l["position"]
        col[i] = l.get("color", (1.0, 1.0, 1.0))
        wat[i] = l.get("wattage", 0.0)
        if "normal" in l:
            v = np.asarray(l["normal"], np.float64)
            nrm[i] = v / np.linalg.norm(v)
        rad[i] = l.get("radius", 1.0)
        dim[i] = l.get("dims", (1.0, 1.0))
    return light_table_from_arrays(kind, pos, nrm, col, wat, rad, dim, device)


def light_table_from_arrays(kind, pos, nrm, col, wat, rad, dim,
                            device="cpu") -> LightTable:
    t = lambda x, dt: torch.as_tensor(np.array(x, dt), device=device)
    kind = np.asarray(kind, np.int32)
    return LightTable(kind=t(kind, np.int32), position=t(pos, np.float32),
                      normal=t(nrm, np.float32), color=t(col, np.float32),
                      wattage=t(wat, np.float32), radius=t(rad, np.float32),
                      dims=t(dim, np.float32),
                      kinds=tuple(int(k) for k in kind))


@dataclasses.dataclass
class NEESample:
    """Per-shading-point NEE quantities for one light (Phong.cpp:78-156)."""
    l: torch.Tensor         # (N, 3) unit direction toward the light
    dist: torch.Tensor      # (N,) shadow-ray tMax
    falloff: torch.Tensor   # (N,) reference falloff term
    in_beam: torch.Tensor   # (N,) bool (True for point lights)
    n_dot_l: torch.Tensor   # (N,)


def nee_sample(lt: LightTable, li: int, p: torch.Tensor,
               n: torch.Tensor) -> NEESample:
    """The geometry part of the Phong::shade light loop (Phong.cpp:
    81-88, 140) for light `li`. p, n: (N, 3) points and normals."""
    if lt.kinds[li] != LIGHT_POINT:
        raise NotImplementedError(
            f"light kind {lt.kinds[li]}: only point lights are ported; "
            "square and directional-area lights come with ROADMAP item A11")
    l_vec = lt.position[li] - p
    fall2 = dot(l_vec, l_vec)
    fall2c = torch.clamp(fall2, min=1e-30)
    dist = torch.sqrt(fall2c)
    return NEESample(
        l=l_vec / dist[..., None],
        dist=dist,
        falloff=1.0 / (fall2c * 4.0 * PI * PI),
        in_beam=torch.ones(dist.shape, dtype=torch.bool, device=p.device),
        n_dot_l=dot(n, l_vec / dist[..., None]))
