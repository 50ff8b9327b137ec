"""|G - G_ref| / |G_ref| (Frobenius) of the gradient of the triangles'
first vertices, the port's rows in the reference's triangle order."""

import math

import torch


def read(got, want):
    g, r = got.get("v0_grad"), want["v0_grad"]
    if g is None or g.shape != r.shape:
        return float("inf")
    err = float(torch.linalg.norm(g - r) / torch.linalg.norm(r))
    return err if math.isfinite(err) else float("inf")
