"""Tonemapping and NaN scrub.

Counterpart of cse168_raytracer_tpu/render/tonemap.py:9-44 (Scene.cpp:
87-91, 180-202; Image.cpp:47-63).
"""

from __future__ import annotations

import torch


def sigmoid_tonemap(hdr: torch.Tensor) -> torch.Tensor:
    """NaN and inf pixels take the image's largest finite value, then
    sigmoid(6v - 3) per channel. hdr: (..., 3) linear radiance."""
    finite = torch.isfinite(hdr)
    max_intensity = torch.where(finite, hdr, -torch.inf).max()
    scrubbed = torch.where(finite, hdr, max_intensity)
    return 1.0 / (1.0 + torch.exp(-(6.0 * scrubbed - 3.0)))


def normalized_tonemap(hdr: torch.Tensor) -> torch.Tensor:
    """The reference's commented-out curve min((v / max)^0.35 * 1.1, 1)
    (Scene.cpp:90), the A2-era golden images' curve; NaN and inf pixels
    take the largest finite value first."""
    finite = torch.isfinite(hdr)
    max_intensity = torch.clamp(torch.where(finite, hdr, -torch.inf).max(),
                                min=1e-12)
    scrubbed = torch.where(finite, hdr, max_intensity)
    return torch.clamp((torch.clamp(scrubbed, min=0.0) / max_intensity)
                       ** 0.35 * 1.1, max=1.0)


def tonemap(hdr: torch.Tensor, kind: str = "sigmoid") -> torch.Tensor:
    """`sigmoid` (the reference's current pass), `normalized`, or `none`
    (a clip to [0, 1])."""
    if kind == "sigmoid":
        return sigmoid_tonemap(hdr)
    if kind == "normalized":
        return normalized_tonemap(hdr)
    if kind == "none":
        return torch.clamp(hdr, 0.0, 1.0)
    raise ValueError(f"unknown tonemap {kind!r}")


def to_bytes(mapped: torch.Tensor) -> torch.Tensor:
    """Image::setPixel float-to-byte clamp (Image.cpp:47-63)."""
    return torch.clamp(mapped * 255.0, 0.0, 255.0).to(torch.uint8)
