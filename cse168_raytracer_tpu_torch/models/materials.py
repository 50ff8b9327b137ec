"""Material parameter table (structure of arrays; kd is learnable).

Counterpart of cse168_raytracer_tpu/models/materials.py, with the same
semantics:
- Phong ctor energy clamp (Phong.cpp:23-31): kt := clip(kt, 0, 1-ks);
  kd := clip(kd, 0, 1-ks-kt), in `energy_clamp`.
- Flags (Material.h:32-34): reflective = any(ks>0), refractive =
  any(kt>0), diffuse = any(kd>0).
- The plain-Phong kd^2 quirk (Phong.cpp:146): TEX_CONSTANT materials use
  kd as their texture colour and multiply by kd again in shading.
- Perfect mirrors store SHININESS_INF in place of the reference's
  `infinity` shininess (Phong.cpp:149).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cse168_raytracer_tpu_torch.config import resolve_device
from cse168_raytracer_tpu_torch.core.fastgather import take_rows

SHININESS_INF = 1.0e30

# texture_kind codes, as in the JAX package (evaluated in models/textures.py)
TEX_CONSTANT = 0
TEX_CHECKER = 1
TEX_STONE = 2
TEX_CLOUD = 3
TEX_PETAL = 4
TEX_STEM = 5
TEX_LEAF = 6
TEX_FLOWER_CENTER = 7
TEX_IMAGE = 8
TEX_CELLULAR = 9

# the kinds looked up by world position (GetLookupCoordinates() == UVW;
# JAX models/materials.py:53 UVW_KINDS)
UVW_KINDS = (TEX_CLOUD, TEX_PETAL, TEX_LEAF, TEX_FLOWER_CENTER)

N_TEX_PARAMS = 12


@dataclasses.dataclass
class MaterialTable:
    """All scene materials as (M, ...) tensors."""
    kd: torch.Tensor              # (M, 3) clamped diffuse
    ks: torch.Tensor              # (M, 3) specular / reflection
    kt: torch.Tensor              # (M, 3) transmission
    shininess: torch.Tensor       # (M,)
    ior: torch.Tensor             # (M,)
    texture_kind: torch.Tensor    # (M,) int32
    texture_params: torch.Tensor  # (M, N_TEX_PARAMS)
    texture_color2: torch.Tensor  # (M, 3)
    image_id: torch.Tensor        # (M,) int32

    @property
    def num_materials(self) -> int:
        return self.kd.shape[0]

    def replace(self, **kw) -> "MaterialTable":
        return dataclasses.replace(self, **kw)


def energy_clamp(kd, ks, kt):
    """Phong ctor energy balance (Phong.cpp:23-31), differentiable."""
    kt = torch.minimum(torch.clamp(kt, min=0.0),
                       torch.clamp(1.0 - ks, min=0.0))
    kd = torch.minimum(torch.clamp(kd, min=0.0),
                       torch.clamp(1.0 - ks - kt, min=0.0))
    return kd, kt


def is_reflective(mat: MaterialTable, mid: torch.Tensor) -> torch.Tensor:
    return (take_rows(mat.ks, mid) > 0.0).any(-1)


def is_refractive(mat: MaterialTable, mid: torch.Tensor) -> torch.Tensor:
    return (take_rows(mat.kt, mid) > 0.0).any(-1)


def is_diffuse(mat: MaterialTable, mid: torch.Tensor) -> torch.Tensor:
    return (take_rows(mat.kd, mid) > 0.0).any(-1)


class MaterialBuilder:
    """Host-side accumulation of materials into a MaterialTable, as
    scene code like `new Phong(kd, ks, kt, s, ior)` (assignment2.cpp:
    417-435) does, returning integer material ids."""

    def __init__(self):
        self._rows = []

    def phong(self, kd=(1.0, 1.0, 1.0), ks=(0.0, 0.0, 0.0),
              kt=(0.0, 0.0, 0.0), shininess=1.0, ior=1.0) -> int:
        """Plain Phong (Lambert is Phong with defaults, Lambert.h:9)."""
        return self._add(kd, ks, kt, shininess, ior, TEX_CONSTANT,
                         np.zeros(N_TEX_PARAMS), (0, 0, 0), -1)

    def textured(self, kind: int, params, ks=(0.0, 0.0, 0.0),
                 kt=(0.0, 0.0, 0.0), shininess=1.0, ior=1.0,
                 color1=(1.0, 1.0, 1.0), color2=(0.0, 0.0, 0.0),
                 image_id: int = -1) -> int:
        """TexturedPhong: kd = 1 (Texture.cpp:513-514); a checker keeps
        color1 in kd."""
        p = np.zeros(N_TEX_PARAMS, np.float32)
        params = np.asarray(params, np.float32).ravel()
        p[:params.shape[0]] = params
        return self._add(color1 if kind == TEX_CHECKER else (1.0, 1.0, 1.0),
                         ks, kt, shininess, ior, kind, p, color2, image_id)

    def _add(self, kd, ks, kt, shininess, ior, kind, params, color2,
             image_id) -> int:
        if shininess == float("inf"):
            shininess = SHININESS_INF
        self._rows.append((np.asarray(kd, np.float32),
                           np.asarray(ks, np.float32),
                           np.asarray(kt, np.float32),
                           np.float32(shininess), np.float32(ior),
                           np.int32(kind), np.asarray(params, np.float32),
                           np.asarray(color2, np.float32),
                           np.int32(image_id)))
        return len(self._rows) - 1

    def build(self, device=None) -> MaterialTable:
        device = resolve_device(device)
        if not self._rows:
            self.phong()
        col = lambda i: torch.as_tensor(np.stack([r[i] for r in self._rows]),
                                        device=device)
        ks = col(1)
        kd, kt = energy_clamp(col(0), ks, col(2))
        return MaterialTable(kd=kd, ks=ks, kt=kt, shininess=col(3),
                             ior=col(4), texture_kind=col(5),
                             texture_params=col(6), texture_color2=col(7),
                             image_id=col(8))
