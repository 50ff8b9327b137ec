"""Sampling transforms as functions of explicit uniforms.

Counterpart of cse168_raytracer_tpu/core/sampling.py:28-110. Each
sampler is split in two:
- a pure function of uniforms `u` in [0, 1) (the last axis holds the
  two numbers of one draw), which tests feed the very numbers that
  jax.random drew for the JAX function;
- a `draw_*` wrapper that draws those uniforms from a torch.Generator
  on the tensors' device and calls it. PyTorch cannot replay jax.random
  streams, so a render compares with the JAX package statistically,
  while each transform compares exactly.

Transforms (Ray.h:109-165, Utility.h:53-95, SquareLight.h:23-39):
- cosine_hemisphere: polar asin(sqrt(u0)), azimuth 2 pi u1 (Ray.h:132);
- phong_lobe: polar acos(u0^(1/(1+s))) with u0 clipped to [1e-12, 1]
  so the power stays differentiable, azimuth 2 pi u1 (Ray.h:152);
- uniform_sphere, uniform_hemisphere and uniform_disc by inverse CDF
  in place of the reference's rejection loops;
- stratified_grid_jitter: n_side^2 jittered cells of [0, 1)^2;
- cosine_hemisphere_about (the direction alone, SquareLight.h:41-48)
  and sphere_surface_to_dir (a uniform direction in n's frame), for
  photon emission.
"""

from __future__ import annotations

import torch

from cse168_raytracer_tpu_torch.config import PI
from cse168_raytracer_tpu_torch.core.vecmath import (align_hemisphere,
                                                     div_scalar, dot, onb,
                                                     safe_normalize, sqrt_rn)


_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, i: int) -> int:
    """The seed of stream i of a render seeded with `seed`, the port's
    counterpart of jax.random.fold_in(key, i), which torch.Generator
    cannot replay: x = seed * 0x9E3779B97F4A7C15 + i + 1 (mod 2^64), then
    SplitMix64's finalizer (x ^= x >> 30; x *= 0xBF58476D1CE4E5B9;
    x ^= x >> 27; x *= 0x94D049BB133111EB; x ^= x >> 31, mod 2^64), kept
    to 63 bits. A function of the two integers alone, so every process
    and device derives the same seed for the same stream."""
    x = (seed * 0x9E3779B97F4A7C15 + i + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) >> 1


def stream(seed: int, i: int, device) -> torch.Generator:
    """A generator on `device` seeded with fold_seed(seed, i)."""
    return torch.Generator(device=device).manual_seed(fold_seed(seed, i))


def uniform(gen: torch.Generator, shape, device=None) -> torch.Tensor:
    """float32 uniforms in [0, 1) of `shape`, drawn from `gen` on the
    generator's own device and placed on `device` (default: that one).
    A CPU generator thus feeds a render on the card the very numbers it
    feeds the same render on the CPU."""
    u = torch.rand(tuple(shape), generator=gen, device=gen.device)
    return u if device is None else u.to(device)


def cosine_hemisphere(u: torch.Tensor, n: torch.Tensor):
    """Cosine-weighted direction about the unit normal n; u (..., 2).
    Returns (direction, pdf = cos(theta) / pi)."""
    phi_polar = torch.asin(sqrt_rn(u[..., 0]))
    theta = 2.0 * PI * u[..., 1]
    return (align_hemisphere(n, theta, phi_polar),
            div_scalar(torch.cos(phi_polar), PI))


def phong_lobe(u: torch.Tensor, axis: torch.Tensor, shininess: torch.Tensor):
    """Glossy direction about `axis` with Phong exponent `shininess`;
    u (..., 2). Returns (direction, cos_alpha); the pdf is
    (s + 1) / (2 pi) cos_alpha^s."""
    u0 = torch.clamp(u[..., 0], 1e-12, 1.0)
    cos_alpha = u0 ** (1.0 / (1.0 + shininess))
    phi_polar = torch.acos(torch.clamp(cos_alpha, -1.0, 1.0))
    theta = 2.0 * PI * u[..., 1]
    return align_hemisphere(axis, theta, phi_polar), cos_alpha


def uniform_sphere(u: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the unit sphere; u (..., 2) -> (..., 3)."""
    z = 1.0 - 2.0 * u[..., 0]
    r = sqrt_rn(torch.clamp(1.0 - z * z, min=0.0))
    theta = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta), z], -1)


def uniform_hemisphere(u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the hemisphere about the unit normal n."""
    d = uniform_sphere(u)
    return torch.where((dot(d, n) < 0.0)[..., None], -d, d)


def uniform_disc(u: torch.Tensor, radius) -> torch.Tensor:
    """Uniform point on a disc of `radius`; u (..., 2) -> (..., 2)."""
    r = radius * sqrt_rn(u[..., 0])
    theta = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], -1)


def stratified_grid_jitter(u: torch.Tensor, n_side: int) -> torch.Tensor:
    """n_side^2 stratified points of [0, 1)^2; u (n_side, n_side, 2)."""
    i = torch.arange(n_side, dtype=u.dtype, device=u.device)
    ij = torch.stack(torch.meshgrid(i, i, indexing="ij"), -1)
    return div_scalar(ij + u, n_side).reshape(n_side * n_side, 2)


def cosine_hemisphere_about(u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """cosine_hemisphere's direction alone (a square light's photon
    emission, SquareLight.h:41-48, takes the same asin(sqrt) draw)."""
    return cosine_hemisphere(u, n)[0]


def sphere_surface_to_dir(u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """A uniform sphere direction expressed in the tangent frame of the
    unit normal n; u (..., 2)."""
    t1, t2 = onb(n)
    d = uniform_sphere(u)
    return safe_normalize(d[..., 0:1] * t1 + d[..., 1:2] * t2
                          + d[..., 2:3] * n)


def draw_cosine_hemisphere(gen: torch.Generator, n: torch.Tensor):
    return cosine_hemisphere(uniform(gen, n.shape[:-1] + (2,), n.device), n)


def draw_phong_lobe(gen: torch.Generator, axis: torch.Tensor, shininess):
    return phong_lobe(uniform(gen, axis.shape[:-1] + (2,), axis.device),
                      axis, shininess)


def draw_uniform_sphere(gen: torch.Generator, shape, device=None):
    return uniform_sphere(uniform(gen, tuple(shape) + (2,), device))


def draw_uniform_hemisphere(gen: torch.Generator, n: torch.Tensor):
    return uniform_hemisphere(
        uniform(gen, n.shape[:-1] + (2,), n.device), n)


def draw_uniform_disc(gen: torch.Generator, radius, shape, device=None):
    return uniform_disc(uniform(gen, tuple(shape) + (2,), device), radius)


def draw_cosine_hemisphere_about(gen: torch.Generator, n: torch.Tensor):
    return cosine_hemisphere_about(
        uniform(gen, n.shape[:-1] + (2,), n.device), n)


def draw_sphere_surface_to_dir(gen: torch.Generator, n: torch.Tensor):
    return sphere_surface_to_dir(
        uniform(gen, n.shape[:-1] + (2,), n.device), n)


def draw_stratified_grid_jitter(gen: torch.Generator, n_side: int,
                                device=None):
    return stratified_grid_jitter(
        uniform(gen, (n_side, n_side, 2), device), n_side)
