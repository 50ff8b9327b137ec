"""Largest |g - g_ref| / |g_ref| over the entries of kd's gradient
(entries whose reference is 0 count |g| / max |g_ref|)."""

import torch


def read(got, want):
    g, r = got.get("kd_grad"), want["kd_grad"]
    if g is None or g.shape != r.shape:
        return float("inf")
    den = torch.where(r.abs() > 0, r.abs(), r.abs().max().clamp(min=1e-30))
    err = ((g - r).abs() / den).max()
    return float(err) if bool(torch.isfinite(err)) else float("inf")
