"""Host-side image output (counterpart of cse168_raytracer_tpu/render/
image_io.py:14-32, which replaces Image.cpp and FreeImage).

Row 0 of the in-memory buffer is the BOTTOM scanline (eyeRay's v axis
grows upward, Camera.cpp:158), as in the reference's Image; the files
store rows top-down. PPM is binary P6 (Image.cpp:98-115). PNG is written
with the standard library alone (zlib and struct: 8-bit RGB, filter 0
on every row), where the JAX package uses imageio, which the port does
not depend on.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _top_down(rgb8) -> np.ndarray:
    rgb8 = np.asarray(rgb8, np.uint8)
    if rgb8.ndim != 3 or rgb8.shape[2] != 3:
        raise ValueError(f"need an (H, W, 3) image, got {rgb8.shape}")
    return np.ascontiguousarray(rgb8[::-1])


def write_ppm(path: str, rgb8) -> None:
    """rgb8: (H, W, 3) uint8, bottom-up rows."""
    img = _top_down(rgb8)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def write_png(path: str, rgb8) -> None:
    """rgb8: (H, W, 3) uint8, bottom-up rows."""
    img = _top_down(rgb8)
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        # width, height, bit depth 8, colour type 2 (RGB), deflate,
        # adaptive filtering, no interlace
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2,
                                                0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))


def write_image(path: str, rgb8) -> None:
    """PPM for a .ppm path, PNG otherwise (as the JAX package)."""
    if path.endswith(".ppm"):
        write_ppm(path, rgb8)
    else:
        write_png(path, rgb8)
