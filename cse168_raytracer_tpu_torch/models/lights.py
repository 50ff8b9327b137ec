"""Light table, light origins and next-event-estimation geometry.

Counterpart of cse168_raytracer_tpu/models/lights.py:51-176, with
photon emission directions (`sample_photon_direction`, lines 114-124):
- LIGHT_POINT (PointLight.h:8-63): the origin is the position; NEE
  falloff 1/(4 pi^2 r^2) (Phong.cpp:140);
- LIGHT_SQUARE (SquareLight.h:23-39): the origin is a jittered point in
  cell (sx, sy) of the sqrt(total_samples)-sided grid over the
  rectangle; it then shades like a point light at that origin;
- LIGHT_DIRECTIONAL_AREA (DirectionalAreaLight.h, Phong.cpp:122-136):
  disc origins; NEE direction -normal, dist 1, falloff 1/pi, and a
  shading point lit only inside the beam of the disc.
The kind of each light is known on the host (`LightTable.kinds`), so
each call computes its own kind's branch where the JAX package selects
among all three. Origins and photon directions are functions of
explicit uniforms (see core/sampling.py); the `draw_*` wrappers take
them from a generator.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cse168_raytracer_tpu_torch.config import PI, resolve_device
from cse168_raytracer_tpu_torch.core.sampling import (cosine_hemisphere_about,
                                                      uniform, uniform_disc,
                                                      uniform_sphere)
from cse168_raytracer_tpu_torch.core.vecmath import (div_scalar, dot, onb,
                                                     sqrt_rn)

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


def make_light_table(lights: list[dict], device=None) -> LightTable:
    """lights: dicts with kind/position/color/wattage and optional
    normal/radius/dims."""
    device = resolve_device(device)
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
                            device=None) -> LightTable:
    device = resolve_device(device)
    t = lambda x, dt: torch.as_tensor(np.array(x, dt), device=device)
    kind = np.asarray(kind, np.int32)
    return LightTable(kind=t(kind, np.int32), position=t(pos, np.float32),
                      normal=t(nrm, np.float32), color=t(col, np.float32),
                      wattage=t(wat, np.float32), radius=t(rad, np.float32),
                      dims=t(dim, np.float32),
                      kinds=tuple(int(k) for k in kind))


def sample_origin(lt: LightTable, li: int, u: torch.Tensor,
                  sample_idx: int = 0, total_samples: int = 1):
    """samplePhotonOrigin of light li for each row of u (..., 2)
    uniforms: the position (point); a jittered point of the
    stratification cell sample_idx of total_samples (square; the
    reference truncates the grid side to int for the cell index and
    keeps it as a float for the cell size); a uniform point of the
    radius disc (directional-area). Both area kinds lie in the light's
    orthonormal tangent frame. A point light ignores u."""
    kind = lt.kinds[li]
    pos = lt.position[li]
    shape = u.shape[:-1] + (3,)
    if kind == LIGHT_POINT:
        return pos.expand(shape)
    t1, t2 = onb(lt.normal[li])
    if kind == LIGHT_SQUARE:
        side = float(np.sqrt(float(total_samples)))
        du_dv = div_scalar(lt.dims[li], side)
        cell = u.new_tensor([sample_idx % int(side), sample_idx // int(side)])
        uv = (u + cell) * du_dv - 0.5 * lt.dims[li]
    elif kind == LIGHT_DIRECTIONAL_AREA:
        uv = uniform_disc(u, lt.radius[li])
    else:
        raise ValueError(f"unknown light kind {kind}")
    return pos + uv[..., 0:1] * t1 + uv[..., 1:2] * t2


def sample_photon_direction(lt: LightTable, li: int,
                            u: torch.Tensor) -> torch.Tensor:
    """samplePhotonDirection of light li for each row of u (..., 2):
    a uniform sphere direction (point, PointLight.h:28-31); cosine
    about the normal (square, SquareLight.h:41-48); the normal itself
    (directional-area, DirectionalAreaLight.h:31-34), which ignores u.
    The JAX function draws the sphere and the cosine sample from one
    key, so both kinds read the same uniforms here too."""
    kind = lt.kinds[li]
    nrm = lt.normal[li].expand(u.shape[:-1] + (3,))
    if kind == LIGHT_POINT:
        return uniform_sphere(u)
    if kind == LIGHT_SQUARE:
        return cosine_hemisphere_about(u, nrm)
    if kind == LIGHT_DIRECTIONAL_AREA:
        return nrm
    raise ValueError(f"unknown light kind {kind}")


def draw_sample_photon_direction(lt: LightTable, li: int,
                                 gen: torch.Generator, shape, device=None):
    """sample_photon_direction with its uniforms drawn from gen."""
    return sample_photon_direction(
        lt, li, uniform(gen, tuple(shape) + (2,), device))


@dataclasses.dataclass
class NEESample:
    """Per-shading-point NEE quantities for one light (Phong.cpp:78-156)."""
    l: torch.Tensor         # (N, 3) unit direction toward the light
    dist: torch.Tensor      # (N,) shadow-ray tMax
    falloff: torch.Tensor   # (N,) reference falloff term
    in_beam: torch.Tensor   # (N,) bool (True for point lights)
    n_dot_l: torch.Tensor   # (N,)


def nee_sample(lt: LightTable, li: int, p: torch.Tensor, n: torch.Tensor,
               u: torch.Tensor | None = None, sample_idx: int = 0,
               total_samples: int = 1) -> NEESample:
    """The geometry part of the Phong::shade light loop (Phong.cpp:
    77-140) for light li at points p and normals n (N, 3). u (N, 2)
    places a square light's origin (cell sample_idx of total_samples);
    point and directional-area lights take none."""
    kind = lt.kinds[li]
    if kind == LIGHT_DIRECTIONAL_AREA:
        nrm = lt.normal[li]
        pos = lt.position[li]
        # the beam test (Phong.cpp:122-136): t = dot(normal, pos - p) /
        # -1, lit iff |(p - t normal) - pos|^2 <= radius^2
        t_beam = dot(nrm, pos - p) / -1.0
        beam = (p - t_beam[..., None] * nrm) - pos
        ones = torch.ones(p.shape[:-1], device=p.device)
        return NEESample(l=(-nrm).expand(p.shape), dist=ones,
                         falloff=ones * (1.0 / PI),
                         in_beam=dot(beam, beam) <= lt.radius[li] ** 2,
                         n_dot_l=dot(n, -nrm))
    if kind == LIGHT_SQUARE:
        if u is None:
            raise ValueError("a square light's NEE sample needs uniforms")
        origin = sample_origin(lt, li, u, sample_idx, total_samples)
    elif kind == LIGHT_POINT:
        origin = lt.position[li]
    else:
        raise ValueError(f"unknown light kind {kind}")
    l_vec = origin - p
    fall2 = dot(l_vec, l_vec)
    fall2c = torch.clamp(fall2, min=1e-30)
    dist = sqrt_rn(fall2c)
    return NEESample(
        l=l_vec / dist[..., None],
        dist=dist,
        falloff=1.0 / (fall2c * 4.0 * PI * PI),
        in_beam=torch.ones(dist.shape, dtype=torch.bool, device=p.device),
        n_dot_l=dot(n, l_vec / dist[..., None]))


def draw_nee_sample(lt: LightTable, li: int, p: torch.Tensor,
                    n: torch.Tensor, gen: torch.Generator | None,
                    sample_idx: int = 0,
                    total_samples: int = 1) -> NEESample:
    """nee_sample with a square light's uniforms drawn from gen."""
    u = None
    if lt.kinds[li] == LIGHT_SQUARE:
        if gen is None:
            raise ValueError("sampling a square light needs a generator")
        u = uniform(gen, p.shape[:-1] + (2,), p.device)
    return nee_sample(lt, li, p, n, u, sample_idx, total_samples)
