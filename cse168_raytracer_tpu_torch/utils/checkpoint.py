"""Photon-map and render-state checkpoints.

Counterpart of cse168_raytracer_tpu/utils/checkpoint.py.

Photon maps (:24-67, save_photon_maps / load_photon_maps): one .npz with
the JAX package's keys, so a file written by either package loads in
the other. Per map ("g" global, "c" caustic): pos, power, dir, hash,
weight and meta (radius, n_valid, table_size, max_per_cell, knn). The
format keeps no coarse level, so a loaded map has coarse=None, as in
the JAX package.

Render state (:70-82, save_render_state / load_render_state): the
progressive render's accumulator `accum` (pixels, 3), `samples_done`
(the JAX names) and the render's integer `seed`. The JAX package keeps
a jax.random key instead; torch.Generator cannot continue that stream,
so the port's sample i draws from a generator seeded with
core/sampling.fold_seed(seed, i) and the file holds no generator
state: a render resumes alike on the card and on the CPU. A file
without `seed` (one the JAX package wrote) raises ValueError.
"""

from __future__ import annotations

import os

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


def save_render_state(path: str, accum: torch.Tensor, samples_done: int,
                      seed: int) -> None:
    """Write the progressive render's state (the accumulator is read
    back from its device, which waits for it)."""
    np.savez_compressed(path, accum=_np(accum),
                        samples_done=np.int64(samples_done),
                        seed=np.int64(seed))


def load_render_state(path: str, device=None):
    """(accum on `device` (None: the card), samples_done, seed) from a
    file save_render_state wrote, or None when there is no file."""
    if not os.path.exists(path):
        return None
    z = np.load(path)
    if "seed" not in z:
        raise ValueError(f"{path} holds no seed: it was not written by "
                         "this package (the JAX package's random key "
                         "cannot be continued here)")
    accum = torch.as_tensor(z["accum"], device=resolve_device(device))
    return accum, int(z["samples_done"]), int(z["seed"])
