"""Batched 3-vector math and optics for ray tracing.

Counterpart of cse168_raytracer_tpu/core/vecmath.py: (..., 3) tensor
helpers, shape-polymorphic over leading dims and differentiable. The
optics reproduce the reference's semantics exactly:
- reflect: Ray.h:160
- refract: Ray.h:202-243 (total internal reflection falls back to the
  mirror direction)
- fresnel: Ray.h:168-200 (s-polarized only, including the reference's
  omission of the n2 factor on the sqrt term)
- tangent frames: Utility.h:25-31 (getTangents) and
  alignHemisphereToVector (Utility.h:34-50), unnormalized as there

Dot and cross products, norms and integer powers are written as single
IEEE operations (products, sums, one division, one square root) in a
fixed order, never a reduction, `rsqrt` or `pow`. What that buys
depends on the op (chip_smoke.py phase 13 counts each on 2^20 inputs):
- device-stable, so a render on the card rounds as on the CPU: `+`,
  `-`, `*`, tensor / tensor and `1.0 / x` (correctly rounded by both
  PyTorch kernels), the square root through sqrt_rn, and a division by
  a Python number through div_scalar;
- not device-stable: a bare torch.sqrt (PyTorch's float32 root on the
  CPU is an ulp low on about 0.6% of inputs; the card's is correctly
  rounded), a bare `x / c` for a Python number c (the card multiplies
  by the reciprocal, the CPU divides), and the transcendentals (`exp`,
  `sin`, `cos`, `asin`, `acos`, `atan2`, `pow` with a float exponent),
  which neither device rounds correctly and which the port leaves as
  they are (PERF.md lists where each sits).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cse168_raytracer_tpu_torch.config import EPSILON


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis (length 3): (a0 b0 + a1 b1) + a2 b2."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def length2(a: torch.Tensor) -> torch.Tensor:
    """The squared norm over the last axis (JAX core/vecmath.py:39
    length2): dot(a, a)'s fixed order for 3-vectors, a sum otherwise."""
    if a.shape[-1] == 3:
        return dot(a, a)
    return (a * a).sum(-1)


def length(a: torch.Tensor) -> torch.Tensor:
    """The norm over the last axis (JAX core/vecmath.py:43 length), its
    root through sqrt_rn."""
    return sqrt_rn(length2(a))


def offset_ray_origin(p: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """A secondary ray's origin moved EPSILON along its direction, the
    reference's `origin + epsilon * dir` (JAX core/vecmath.py:191
    offset_ray_origin; Ray.h:91, Scene.cpp:535, Phong.cpp:92)."""
    return p + EPSILON * d


def dotk(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis, keeping it (broadcast-friendly)."""
    return dot(a, b)[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, each product rounded on its own."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


class _RootRN(torch.autograd.Function):
    """sqrt_rn off the card: numpy's root, the processor's IEEE square
    root instruction, which is correctly rounded; the gradient is
    torch.sqrt's own formula, grad / (2 * root)."""

    @staticmethod
    def forward(ctx, x):
        with np.errstate(invalid="ignore"):
            root = torch.from_numpy(np.sqrt(x.detach().numpy()))
        ctx.save_for_backward(root)
        return root

    @staticmethod
    def backward(ctx, grad):
        root, = ctx.saved_tensors
        return grad / (2 * root)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The square root rounded to nearest on every device, the port's
    one route to a float32 root. On the card it is torch.sqrt, whose
    float32 kernel is correctly rounded (chip_smoke.py phase 13 checks
    all 2^31 non-negative inputs, subnormals included). PyTorch's CPU
    root kernels are not: the float32 one is an ulp low on about 0.6%
    of inputs, and the float64 one rounded to float32 was seen wrong on
    a few inputs in some runs. So on the CPU the root is numpy's
    (_RootRN). Both routes return the
    same bits and the same gradient, torch.sqrt's grad / (2 * root)."""
    if x.is_cuda:
        return torch.sqrt(x)
    return _RootRN.apply(x)


def div_scalar(x: torch.Tensor, c) -> torch.Tensor:
    """x / c for a Python number c, as XLA (the JAX package's jitted
    functions) and PyTorch's CUDA kernel compute it: x times the float32
    reciprocal of float32(c). PyTorch's CPU kernel divides instead, which
    differs by an ulp on a third to two thirds of inputs unless c is a
    power of two."""
    return x * float(np.float32(1.0) / np.float32(c))


def sum_fixed(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x summed over `dim` in one fixed order on every device: the axis
    padded to a power of two P with -0.0 (the additive identity, so a
    sum of -0.0 stays -0.0), then halved, x[..., :h] + x[..., h:] for
    h = P/2, ..., 1. Elementwise adds only, so the card rounds as the
    CPU does; torch.sum reduces in each device's own order. It is the
    order of a warp reduction whose lane l first sums positions l,
    l + 32, ... by the same halving, then folds lanes by
    __shfl_down_sync at offsets 16, ..., 1."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p > n:
        x = torch.cat([x, x.new_full(x.shape[:-1] + (p - n,), -0.0)], -1)
    while p > 1:
        p //= 2
        x = x[..., :p] + x[..., p:]
    return x[..., 0]


def ipow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x ** n for an integer n >= 1 by repeated squaring, in the order of
    jax.lax.integer_pow (which jnp's `x ** 500` lowers to)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def normalize(a: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Normalize over the last axis; eps > 0 guards zero vectors."""
    n2 = dotk(a, a)
    if eps:
        n2 = torch.clamp(n2, min=eps)
    return a * (1.0 / sqrt_rn(n2))


def safe_normalize(a: torch.Tensor) -> torch.Tensor:
    return normalize(a, eps=1e-30)


@functools.lru_cache(maxsize=None)
def unit_axis(i: int, dtype, device) -> torch.Tensor:
    """The (3,) unit vector along axis i, read-only. Made on `device` at
    its first use, by a fill of zeros and a fill of one element, and kept
    per (i, dtype, device): nothing is copied from the host, which would
    block it, and a frame launches nothing for it."""
    with torch.inference_mode(False):
        e = torch.zeros(3, dtype=dtype, device=device)
        e.narrow(0, i, 1).fill_(1.0)
    return e


def _axis(like: torch.Tensor, i: int) -> torch.Tensor:
    """The unit vector along axis i, broadcast to `like`'s shape."""
    return unit_axis(i, like.dtype, like.device).expand(like.shape)


def get_tangents(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two tangents of n as Utility.h:25-31 builds them: t1 = z x n, or
    y x n where that is degenerate, and t2 = t1 x n. Not normalized, as
    in the reference (see onb for an orthonormal frame)."""
    t1a = cross(_axis(n, 2), n)
    t1 = torch.where((dot(t1a, t1a) < 1e-6)[..., None],
                     cross(_axis(n, 1), n), t1a)
    return t1, cross(t1, n)


def onb(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Orthonormal tangents (t1, t2) completing the unit normal n."""
    t1, t2 = get_tangents(n)
    return safe_normalize(t1), safe_normalize(t2)


def align_hemisphere(v: torch.Tensor, theta: torch.Tensor,
                     phi: torch.Tensor) -> torch.Tensor:
    """The direction at azimuth theta and polar angle phi about axis v,
    as alignHemisphereToVector (Utility.h:34-50) computes it, with its
    UNNORMALIZED tangent frame: t1 = z x v has length |v| sin(v, z) and
    t2 = t1 x v length |t1| |v|, so the tangential part is scaled by
    sin(v, z) before the final normalize and the lobe is squeezed toward
    v. That warp is kept on purpose (JAX core/vecmath.py:90-104): with
    a normalized frame the JAX package's photon maps stored 21% too much
    energy against the reference, which applies the same warp to every
    diffuse bounce and Phong lobe and never divides by the pdf.
    sin and cos are the library's own (they may differ by an ulp between
    the CPU and the card); the products and sums are single IEEE
    operations in a fixed order."""
    t1, t2 = get_tangents(v)
    sp = torch.sin(phi)[..., None]
    u1 = sp * torch.cos(theta)[..., None]
    u2 = sp * torch.sin(theta)[..., None]
    u3 = torch.cos(phi)[..., None]
    return safe_normalize(u1 * t1 + u2 * t2 + u3 * v)


def rotate_about_axis(v: torch.Tensor, theta, w: torch.Tensor) -> torch.Tensor:
    """Vector3::rotated(theta, w) (Vector3.h:217-224; JAX
    core/vecmath.py:119-125): v rotated about the axis w (normalized
    here) by theta radians, by Rodrigues' formula. A Python theta is
    taken as float32, as jnp takes it."""
    w = safe_normalize(w)
    theta = torch.as_tensor(theta, dtype=v.dtype, device=v.device)
    c = torch.cos(theta)
    s = torch.sin(theta)
    return v * c + cross(w, v) * s + w * dotk(w, v) * (1.0 - c)


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of direction d about normal n (Ray.h:160)."""
    return d - 2.0 * dotk(n, d) * n


def _oriented_ior(d, n, ior):
    """(n1, n2, oriented normal) per Ray.h:173-185: entering when d.n<0."""
    entering = dotk(d, n) < 0.0
    one = torch.ones_like(ior)
    n1 = torch.where(entering[..., 0], one, ior)
    n2 = torch.where(entering[..., 0], ior, one)
    n_or = torch.where(entering, n, -n)
    return n1, n2, n_or


def fresnel_rs(d: torch.Tensor, n: torch.Tensor,
               ior: torch.Tensor) -> torch.Tensor:
    """S-polarized Fresnel reflection coefficient, Ray.h:168-200, with
    the reference's missing n2 factor; 1 above the critical angle."""
    n1, n2, n_or = _oriented_ior(d, n, ior)
    cos_t = torch.clamp(dot(-d, n_or), -1.0, 1.0)
    # sin^2 = 1 - cos^2 directly: d(acos)/dx is infinite at normal
    # incidence and would NaN every gradient through Fresnel
    pow_something = (n1 / n2) ** 2 * (1.0 - cos_t ** 2)
    tir = pow_something > 1.0
    s2 = torch.clamp(1.0 - pow_something, min=0.0)
    # safe sqrt: zero gradient at the critical angle, same forward value
    sqrt_term = torch.where(s2 > 0, sqrt_rn(torch.where(s2 > 0, s2, 1.0)), 0.0)
    denom = n1 * cos_t + sqrt_term
    rs = ((n1 * cos_t - sqrt_term)
          / torch.where(denom.abs() < 1e-20, 1e-20, denom)) ** 2
    return torch.where(tir, 1.0, rs)


def refract(d: torch.Tensor, n: torch.Tensor, ior: torch.Tensor):
    """Snell refraction with the TIR fallback (Ray.h:202-243).

    Returns (direction, tir_mask); where tir_mask is set the direction
    is the mirror reflection, as in the reference."""
    n1, n2, n_or = _oriented_ior(d, n, ior)
    d_dot_n = dot(d, n_or)
    energy = 1.0 - (n1 ** 2) * (1.0 - d_dot_n ** 2) / (n2 ** 2)
    tir = energy < 0.0
    e = torch.clamp(energy, min=0.0)
    root = torch.where(e > 0, sqrt_rn(torch.where(e > 0, e, 1.0)), 0.0)
    refr = (n1[..., None] * (d - n_or * d_dot_n[..., None]) / n2[..., None]
            - n_or * root[..., None])
    refl = reflect(d, n)
    return torch.where(tir[..., None], refl, refr), tir
