"""The reference's scene: flat triangle arrays, materials, lights and the
camera, made from the raw scene that a configuration's build_raw returns.

A raw scene is a dict:
  meshes     [(mesh, material index)], a mesh being the dict of
             `vertices` (V, 3), `normals` (Vn, 3), `tri_vidx` (T, 3) and
             `tri_nidx` (T, 3), as OBJ files give them;
  materials  [dict(kd, ks, kt, ior, shininess)];
  lights     [dict(kind="point", position, color, wattage)] or
             [dict(kind="directional_area", position, normal, radius,
             color, wattage)];
  camera     dict(eye, look_at, up, fov).
Each triangle is its first vertex a and the edges b - a and c - a, taken
in float64 and rounded once, so the reference's triangles are the same
numbers as any float32 renderer that does the same.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

EPSILON = 1e-4           # ray offset, Miro.h:9
TMAX = 1e12              # Miro.h:8
SHININESS_INF = 1.0e30   # a material with no highlight


@dataclasses.dataclass
class RefScene:
    v0: torch.Tensor      # (T, 3)
    e1: torch.Tensor      # (T, 3)
    e2: torch.Tensor      # (T, 3)
    n0: torch.Tensor      # (T, 3) vertex normals
    n1: torch.Tensor
    n2: torch.Tensor
    mat: torch.Tensor     # (T,) int64
    kd: torch.Tensor      # (M, 3)
    ks: torch.Tensor      # (M, 3)
    kt: torch.Tensor      # (M, 3)
    ior: torch.Tensor     # (M,)
    shininess: torch.Tensor  # (M,)
    lights: list
    camera: dict
    v0_host: np.ndarray   # (T, 3) float32, e1_host, e2_host: for matching
    e1_host: np.ndarray
    e2_host: np.ndarray

    @property
    def num_tris(self) -> int:
        return self.v0.shape[0]

    @property
    def any_refractive(self) -> bool:
        return bool((self.kt > 0).any())

    @property
    def can_spawn(self) -> bool:
        return bool((self.kt > 0).any() or (self.ks > 0).any())


def triangles(meshes):
    """(v0, e1, e2, n0, n1, n2, material) float32 / int64 numpy arrays of
    the raw meshes, concatenated in order."""
    cols = [[] for _ in range(7)]
    for mesh, m in meshes:
        v = np.asarray(mesh["vertices"], np.float64)
        n = np.asarray(mesh["normals"], np.float64)
        vi = np.asarray(mesh["tri_vidx"], np.int64)
        ni = np.asarray(mesh["tri_nidx"], np.int64)
        a, b, c = v[vi[:, 0]], v[vi[:, 1]], v[vi[:, 2]]
        for col, x in zip(cols, (a, b - a, c - a, n[ni[:, 0]], n[ni[:, 1]],
                                 n[ni[:, 2]])):
            col.append(x.astype(np.float32))
        cols[6].append(np.full(vi.shape[0], m, np.int64))
    return tuple(np.concatenate(c) for c in cols)


def build(raw: dict, device, dtype=torch.float32) -> RefScene:
    v0, e1, e2, n0, n1, n2, mat = triangles(raw["meshes"])
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                  device=device).to(dtype)
    mats = raw["materials"]
    col = lambda k, d: [m.get(k, d) for m in mats]
    shin = [SHININESS_INF if math.isinf(s) else s
            for s in col("shininess", 1.0)]
    return RefScene(
        v0=t(v0), e1=t(e1), e2=t(e2), n0=t(n0), n1=t(n1), n2=t(n2),
        mat=torch.as_tensor(mat, device=device),
        kd=t(col("kd", (1, 1, 1))), ks=t(col("ks", (0, 0, 0))),
        kt=t(col("kt", (0, 0, 0))), ior=t(col("ior", 1.0)), shininess=t(shin),
        lights=list(raw["lights"]), camera=dict(raw["camera"]),
        v0_host=v0, e1_host=e1, e2_host=e2)
