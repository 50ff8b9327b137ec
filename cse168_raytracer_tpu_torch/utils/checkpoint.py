"""Photon-map checkpoints.

Counterpart of cse168_raytracer_tpu/utils/checkpoint.py:24-67
(save_photon_maps / load_photon_maps): one .npz with the JAX package's
keys, so a file written by either package loads in the other. Per map
("g" global, "c" caustic): pos, power, dir, hash, weight and meta
(radius, n_valid, table_size, max_per_cell, knn). The format keeps no
coarse level, so a loaded map has coarse=None, as in the JAX package.
The render state of progressive renders is not ported yet (ROADMAP
item A24).
"""

from __future__ import annotations

import numpy as np
import torch

from cse168_raytracer_tpu_torch.config import resolve_device


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_photon_maps(path: str, maps) -> None:
    from cse168_raytracer_tpu_torch.ops.photon import PhotonMaps
    if not isinstance(maps, PhotonMaps):
        raise TypeError(f"expected PhotonMaps, got {type(maps).__name__}")
    data = {}
    for name, g in (("g", maps.global_map), ("c", maps.caustic_map)):
        if g is None:
            continue
        data[f"{name}_pos"] = _np(g.pos)
        data[f"{name}_power"] = _np(g.power)
        data[f"{name}_dir"] = _np(g.dir)
        data[f"{name}_hash"] = _np(g.cell_hash)
        data[f"{name}_weight"] = _np(g.weight)
        data[f"{name}_meta"] = np.asarray(
            [float(g.radius), int(g.n_valid), g.table_size, g.max_per_cell,
             g.knn])
    np.savez_compressed(path, **data)


def load_photon_maps(path: str, device=None):
    """PhotonMaps on `device` (None: the card) from a .npz of either
    package. Files without weights or knn (the JAX package's older
    format) get weight 1 per row and knn 500, as the JAX loader gives."""
    from cse168_raytracer_tpu_torch.ops.photon import PhotonGrid, PhotonMaps
    device = resolve_device(device)
    z = np.load(path)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    def grid(name):
        if f"{name}_pos" not in z:
            return None
        meta = z[f"{name}_meta"]
        n = z[f"{name}_pos"].shape[0]
        wgt = (z[f"{name}_weight"] if f"{name}_weight" in z
               else np.ones(n, np.float32))
        return PhotonGrid(
            pos=t(z[f"{name}_pos"]), power=t(z[f"{name}_power"]),
            dir=t(z[f"{name}_dir"]), weight=t(wgt),
            cell_hash=t(z[f"{name}_hash"]),
            radius=t(np.float32(meta[0])), n_valid=int(meta[1]),
            table_size=int(meta[2]), max_per_cell=int(meta[3]),
            knn=int(meta[4]) if meta.shape[0] > 4 else 500)

    return PhotonMaps(global_map=grid("g"), caustic_map=grid("c"))
