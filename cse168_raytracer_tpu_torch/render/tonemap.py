"""Tonemapping and NaN scrub.

Counterpart of cse168_raytracer_tpu/render/tonemap.py (Scene.cpp:87-91,
180-202; Image.cpp:47-63).
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


def to_bytes(mapped: torch.Tensor) -> torch.Tensor:
    """Image::setPixel float-to-byte clamp (Image.cpp:47-63)."""
    return torch.clamp(mapped * 255.0, 0.0, 255.0).to(torch.uint8)
