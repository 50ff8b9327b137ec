"""Largest |P - P_ref| / |P_ref| over the maps (global, caustic) and the
channels of the stored photons' power summed ("map_power", (2, 3));
where the reference's sum is 0, |P| over the largest reference sum. It
moves with every photon traced, stored or lost otherwise: a map left
out reads 1."""

import math

import torch


def read(got, want):
    g, r = got.get("map_power"), want.get("map_power")
    if g is None or r is None or g.shape != r.shape:
        return float("inf")
    g, r = g.double().cpu(), r.double().cpu()
    den = torch.where(r.abs() > 0, r.abs(),
                      r.abs().max().clamp(min=1e-300))
    err = float(((g - r).abs() / den).max())
    return err if math.isfinite(err) else float("inf")
