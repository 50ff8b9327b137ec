"""Wavefront shading: closest hit, normals, Phong direct lighting.

Counterpart of cse168_raytracer_tpu/ops/shading.py:42-249 (Phong::
shade, Phong.cpp:44-161, and the normal step of Scene::trace, Scene.cpp:
232-266):
- per light and per light sample, a shadow ray from P + l*eps with
  tMax = the light distance; any-hit traversal when nothing is
  refractive, else a closest hit whose refractive occluders attenuate
  by dot(N_occluder, l) instead of blocking (Phong.cpp:98-113);
- point and square-light falloff 1/(4 pi^2 r^2) (Phong.cpp:140), the
  directional-area beam test with falloff 1/pi (models/lights.py);
  square-light origins are drawn from the render's generator, one
  (light, sample) after another, where the JAX package folds the pair
  into its key (ops/shading.py:152-156);
- diffuse term light_color * max(0, nDotL * falloff * wattage) *
  texColor * kd, which is the reference's kd^2 for untextured
  materials since texColor == kd there;
- specular highlight max(0, min(1, dot(e, r)))^500 * falloff * wattage
  added to every channel when shininess < infinity (Phong.cpp:149-156).
Bump maps (Scene.cpp:234-263, JAX ops/shading.py:88-117): central
differences of the bump height in UV, with delta 1e-4, tilt the normal
through the reference's tangent, built on the largest component; without
a bump map the normal step is plain normalization. collect_stats adds up the
traversal's in-kernel counters (kernel K3) over every ray traced, as
int64 sums.
"""

from __future__ import annotations

import torch

from cse168_raytracer_tpu_torch.config import EPSILON, MIRO_TMAX
from cse168_raytracer_tpu_torch.core.fastgather import (select_component,
                                                        take_rows)
from cse168_raytracer_tpu_torch.core.vecmath import (cross, div_scalar, dot,
                                                     ipow, safe_normalize)
from cse168_raytracer_tpu_torch.models.lights import draw_nee_sample
from cse168_raytracer_tpu_torch.models.materials import (SHININESS_INF,
                                                         is_refractive)
from cse168_raytracer_tpu_torch.models.scene import Scene, SceneStatic
from cse168_raytracer_tpu_torch.models.textures import (bump_height,
                                                        diffuse_color)
from cse168_raytracer_tpu_torch.ops.accel import (scene_any_hit,
                                                  scene_closest_hit)
from cse168_raytracer_tpu_torch.ops.intersect import closest_hit
from cse168_raytracer_tpu_torch.ops.surface import Surface, make_surface


def _sum(x) -> torch.Tensor:
    return x.sum(dtype=torch.int64)


def _closest(scene: Scene, o, d, tmin, tmax, with_stats: bool = False):
    """(Hit, triangle attribute rows or None) through the tree when the
    scene has one, else by brute force; with_stats appends the
    traversal's (box tests, triangle tests) summed over the rays (zeros
    without a tree)."""
    if scene.accel is not None:
        hit, attr, *tests = scene_closest_hit(
            scene.accel, scene.spheres, scene.planes, o, d, tmin, tmax,
            with_stats, blpatches=scene.blpatches)
        counts = tuple(_sum(x) for x in tests)
    else:
        hit, attr = closest_hit(scene.tris, scene.spheres, scene.planes, o,
                                d, tmin, tmax, scene.blpatches), None
        zero = torch.zeros((), dtype=torch.int64, device=o.device)
        counts = (zero, zero) if with_stats else ()
    return (hit, attr, *counts)


def _any(scene: Scene, o, d, tmax, with_stats: bool):
    """Shadow occlusion through the tree; with_stats appends the summed
    (box tests, triangle tests)."""
    if not with_stats:
        return (scene_any_hit(scene.accel, scene.spheres, scene.planes, o, d,
                              0.0, tmax, blpatches=scene.blpatches),)
    occ, box, tri = scene_any_hit(scene.accel, scene.spheres, scene.planes,
                                  o, d, 0.0, tmax, with_stats=True,
                                  blpatches=scene.blpatches)
    return occ, _sum(box), _sum(tri)


def trace_closest(scene: Scene, static: SceneStatic, o, d, tmin=0.0,
                  tmax=MIRO_TMAX, collect_stats: bool = False):
    """Scene::trace: closest hit, surface and normalized shading
    normal. Returns (Hit, Surface), and with collect_stats the summed
    (box tests, triangle tests) as a third item."""
    hit, attr, *counts = _closest(scene, o, d, tmin, tmax, collect_stats)
    surf = make_surface(scene.tris, scene.spheres, scene.planes, o, d, hit,
                        tri_attr=attr, blpatches=scene.blpatches)
    surf.n = apply_bump(scene, static, surf)
    return (hit, surf, tuple(counts)) if collect_stats else (hit, surf)


def apply_bump(scene: Scene, static: SceneStatic, surf: Surface):
    """The normal step of Scene.cpp:234-263: the bump-perturbed,
    normalized normal; with no bump map in the scene it reduces to
    normalizing the interpolated normal."""
    n = surf.n
    if not static.any_bump:
        return safe_normalize(n)
    delta = 1e-4                                     # Scene.cpp:235
    mid, uv = surf.material_id, surf.uv
    du = uv.new_tensor([delta, 0.0])
    dv = uv.new_tensor([0.0, delta])
    kinds = static.texture_kinds
    u1 = bump_height(scene.materials, mid, uv - du, kinds)
    u2 = bump_height(scene.materials, mid, uv + du, kinds)
    v1 = bump_height(scene.materials, mid, uv - dv, kinds)
    v2 = bump_height(scene.materials, mid, uv + dv, kinds)
    dx = div_scalar(u2 - u1, 2 * delta)
    dy = div_scalar(v2 - v1, 2 * delta)
    # the reference's tangent (Scene.cpp:252-260): the largest-component
    # axis m, randomVec with -n[m] in a rotated slot, t1 = N x randomVec
    m = torch.where(n[:, 1] > n[:, 0], 1, 0)
    m = torch.where(n[:, 2] > select_component(n, m), 2, m)
    nm = select_component(n, m)
    rand_vec = torch.stack([torch.where(m == 2, -nm, 0.0),
                            torch.where(m == 0, -nm, 0.0),
                            torch.where(m == 1, -nm, 0.0)], dim=-1)
    t1 = cross(n, rand_vec)
    n_t1 = cross(n, t1)
    n_new = n + dx[:, None] * n_t1 - dy[:, None] * cross(n, n_t1)
    return safe_normalize(n_new)


def shade_direct(scene: Scene, static: SceneStatic, ray_d: torch.Tensor,
                 surf: Surface, gen: torch.Generator | None = None,
                 disable_shadows: bool = False, light_samples: int = 1,
                 collect_stats: bool = False):
    """Phong::shade over a wavefront; ray_d: (N, 3) incoming directions;
    gen draws square-light origins (light_samples > 1 stratifies them,
    Phong.cpp:77-80, SquareLight.h:23-39). Returns ((N, 3) direct
    radiance, zero where surf.hit is False; the texture colour; shadow
    rays per shading point), and with collect_stats the (box tests,
    triangle tests) of every shadow traversal summed, in all three
    shadow modes."""
    mats = scene.materials
    mid = surf.material_id
    tex_color = diffuse_color(mats, scene.images, mid, surf.uv, surf.p,
                              static.texture_kinds,
                              cellulars=scene.cellulars)
    kd = take_rows(mats.kd, mid)
    shininess = take_rows(mats.shininess, mid)
    n = surf.n
    e = -ray_d

    total = torch.zeros_like(surf.p)
    n_shadow = 0
    counts = torch.zeros(2, dtype=torch.int64, device=n.device)
    for li in range(static.num_lights):
        for si in range(light_samples):
            s = draw_nee_sample(scene.lights, li, surf.p, n, gen, si,
                                light_samples)
            intensity = torch.ones_like(s.dist)
            occluded = torch.zeros(s.dist.shape, dtype=torch.bool,
                                   device=n.device)
            if not disable_shadows:
                # shadow ray (Phong.cpp:91-114), suppressed for lanes
                # that missed, face away with no highlight, or lie
                # outside a light's beam
                sh_o = surf.p + s.l * EPSILON
                sh_d = s.l
                could_shine = (s.n_dot_l > 0.0) | (shininess < SHININESS_INF)
                sh_live = surf.hit & could_shine & s.in_beam
                sh_tmax = torch.where(sh_live, s.dist, -1.0)
                n_shadow += 1
                if scene.accel is not None and not static.any_refractive:
                    occluded, *tests = _any(scene, sh_o, sh_d, sh_tmax,
                                            collect_stats)
                else:
                    sh_hit, sh_attr, *tests = _closest(
                        scene, sh_o, sh_d, 0.0, sh_tmax, collect_stats)
                    occluded = sh_hit.hit
                    if static.any_refractive:
                        # refractive occluders attenuate instead of block
                        sh_surf = make_surface(scene.tris, scene.spheres,
                                               scene.planes, sh_o, sh_d,
                                               sh_hit, tri_attr=sh_attr,
                                               blpatches=scene.blpatches)
                        occ_refr = is_refractive(mats, sh_surf.material_id)
                        occ_ndl = dot(safe_normalize(sh_surf.n), s.l)
                        pass_through = (occluded & occ_refr
                                        & (occ_ndl >= EPSILON))
                        intensity = torch.where(pass_through, occ_ndl,
                                                intensity)
                        occluded = occluded & ~pass_through
                if collect_stats:
                    counts = counts + torch.stack(tests)
            visible = ~occluded & s.in_beam

            # wattage / samples (Phong.cpp:145,153)
            w = div_scalar(scene.lights.wattage[li], light_samples)
            lcol = scene.lights.color[li]
            diff_term = torch.clamp(s.n_dot_l * s.falloff * w, min=0.0)
            contrib = (lcol * diff_term[..., None] * tex_color * kd
                       * intensity[..., None])
            # specular highlight (Phong.cpp:149-156), a scalar on rgb
            r = -s.l + 2.0 * dot(s.l, n)[..., None] * n
            e_dot_r = ipow(torch.clamp(dot(e, r), 0.0, 1.0), 500)
            highlight = torch.clamp(e_dot_r * s.falloff * w, min=0.0)
            has_highlight = shininess < SHININESS_INF
            contrib = contrib + torch.where(has_highlight, highlight,
                                            0.0)[..., None]
            total = total + torch.where(visible[..., None], contrib, 0.0)

    total = torch.where(surf.hit[..., None], total, 0.0)
    if collect_stats:
        return total, tex_color, n_shadow, (counts[0], counts[1])
    return total, tex_color, n_shadow
