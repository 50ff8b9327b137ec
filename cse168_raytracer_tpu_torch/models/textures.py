"""Textures and the environment.

Counterpart of cse168_raytracer_tpu/models/textures.py:97,544,558,588,
594. Ported so far: the constant (plain Phong) and checkerboard diffuse
colours, and the flat-background and procedural-cloud environments with
the reference's black-cloud quirk (Texture.h:152 hides rather than
overrides lookup2D, so a cloud environment looks up black; testsphere.ppm
has a black sky). The other texture kinds, bump maps and image
environments are ROADMAP item A10 and raise here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cse168_raytracer_tpu_torch.config import resolve_device
from cse168_raytracer_tpu_torch.core.fastgather import take_rows
from cse168_raytracer_tpu_torch.models.materials import (MaterialTable,
                                                         TEX_CHECKER,
                                                         TEX_CONSTANT,
                                                         TEX_STONE)

PORTED_KINDS = (TEX_CONSTANT, TEX_CHECKER)


def checker_lookup(u, v, scale, color1, color2):
    """CheckerBoardTexture::lookup2D (Texture.h:125-132)."""
    su = (scale * u).abs()
    sv = (scale * v).abs()
    su = torch.where(u < 0, su + scale, su)
    sv = torch.where(v < 0, sv + scale, sv)
    parity = (torch.trunc(su).to(torch.int64)
              + torch.trunc(sv).to(torch.int64)) % 2
    return torch.where((parity == 0)[..., None], color1, color2)


@dataclasses.dataclass
class Environment:
    """Scene environment: procedural cloud or flat background."""
    cloud_params: Optional[torch.Tensor]  # (8,) CloudTexture params or None
    rotation: torch.Tensor                # (2,) phi / theta offsets
    bg_color: torch.Tensor                # (3,)
    quirk_cloud_env_black: bool = True


def make_environment(cloud_params=None, rotation=(0.0, 0.0),
                     bg_color=(0.0, 0.0, 0.0),
                     quirk_cloud_env_black: bool = True,
                     device=None) -> Environment:
    device = resolve_device(device)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return Environment(
        cloud_params=None if cloud_params is None else t(cloud_params),
        rotation=t(rotation), bg_color=t(bg_color),
        quirk_cloud_env_black=quirk_cloud_env_black)


def env_lookup(env: Environment, d: torch.Tensor,
               is_diffuse: torch.Tensor) -> torch.Tensor:
    """Scene::getEnvironmentMap (Scene.cpp:657-688). d: (N, 3) unit
    directions; is_diffuse selects an image map's low-res copy."""
    shape = d.shape[:-1]
    if env.cloud_params is None:
        return env.bg_color.expand(shape + (3,))
    if env.quirk_cloud_env_black:
        return torch.zeros(shape + (3,), dtype=torch.float32,
                           device=d.device)
    raise NotImplementedError(
        "cloud environment without the black quirk: ROADMAP item A10")


def active_kinds(mat: MaterialTable) -> tuple[int, ...]:
    """Host-side: the texture kinds the table uses (static)."""
    kinds = np.unique(mat.texture_kind.cpu().numpy())
    return tuple(int(k) for k in kinds)


def has_bump(mat: MaterialTable) -> bool:
    """Host-side: does any material have a bump map (static)."""
    return bool((mat.texture_kind == TEX_STONE).any())


def diffuse_color(mat: MaterialTable, mid: torch.Tensor, uv: torch.Tensor,
                  kinds: tuple[int, ...]) -> torch.Tensor:
    """Material::diffuse2D dispatch (Phong.cpp:51-56) over the kinds the
    scene uses. mid: (N,) material ids; uv: (N, 2)."""
    other = sorted(set(kinds) - set(PORTED_KINDS))
    if other:
        raise NotImplementedError(
            f"texture kinds {other}: ROADMAP item A10")
    kind = take_rows(mat.texture_kind, mid)
    out = torch.zeros(mid.shape + (3,), dtype=torch.float32,
                      device=mid.device)
    kd = take_rows(mat.kd, mid)
    if TEX_CONSTANT in kinds:
        out = torch.where((kind == TEX_CONSTANT)[..., None], kd, out)
    if TEX_CHECKER in kinds:
        scale = take_rows(mat.texture_params, mid)[..., 0]
        c = checker_lookup(uv[..., 0], uv[..., 1], scale, kd,
                           take_rows(mat.texture_color2, mid))
        out = torch.where((kind == TEX_CHECKER)[..., None], c, out)
    return out
