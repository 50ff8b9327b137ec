"""The port's make_surface, shade_direct and ReattachRows against the JAX
package's, on the very same hits.

Rays are made from a seed with numpy; the JAX package's brute-force
closest_hit picks the winners, and both packages turn the same winners
into surfaces and shade the same surface with their own shadow rays (the
JAX package through its CPU accelerator, the port through its wide BVH,
whose traversal runs the plain twin on the CPU)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cse168_raytracer_tpu.ops import intersect as j_intersect  # noqa: E402
from cse168_raytracer_tpu.ops import shading as j_shading  # noqa: E402
from cse168_raytracer_tpu.ops import surface as j_surface  # noqa: E402
from cse168_raytracer_tpu.ops.accel import attach_accel as j_attach  # noqa: E402
from cse168_raytracer_tpu_torch.ops import shading, surface  # noqa: E402
from cse168_raytracer_tpu_torch.ops.accel import attach_accel  # noqa: E402
from cse168_raytracer_tpu_torch.ops.intersect import Hit  # noqa: E402
from test_torch_render import (jax_mixed_scene, jax_scene,  # noqa: E402
                               port_inputs)

SEED = 7
N_RAYS = 512


def scene_pair(name):
    if name == "mixed":
        js, jst, jcam = jax_mixed_scene()
    else:
        from chip_smoke import LIT_LIGHT
        from cse168_raytracer_tpu.models.lights import make_light_table
        js, jst, jcam = jax_scene("sponza_proxy", 16)
        js = js.replace(lights=make_light_table(
            [dict(kind=0, position=LIT_LIGHT, color=(1, 1, 1),
                  wattage=200.0)]))
    ps, pst, _ = port_inputs(js, jst, jcam)
    return js, jst, np.asarray(jcam.eye), ps, pst


def rays_from(eye):
    """Rays from the camera's eye in seeded directions toward -z, so most
    of them hit something."""
    rng = np.random.default_rng(SEED)
    d = rng.normal(0, 1, (N_RAYS, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d[:, 1] -= 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.tile(eye[None].astype(np.float32), (N_RAYS, 1))
    return o, d


def jax_hits(js, o, d):
    return jax.jit(lambda o, d: j_intersect.closest_hit(
        js.tris, js.spheres, js.planes, o, d))(jnp.asarray(o),
                                                jnp.asarray(d))


def port_hit(jh):
    return Hit(**{f: torch.as_tensor(np.array(getattr(jh, f)))
                  for f in ("t", "prim_type", "prim_id", "hit")})


@pytest.mark.parametrize("name", ["mixed", "sponza_lit"])
def test_make_surface_matches_jax(name):
    js, jst, eye, ps, pst = scene_pair(name)
    o, d = rays_from(eye)
    jh = jax_hits(js, o, d)
    jsurf = jax.jit(lambda o, d, h: j_surface.make_surface(
        js.tris, js.spheres, js.planes, o, d, h))(jnp.asarray(o),
                                                   jnp.asarray(d), jh)
    psurf = surface.make_surface(ps.tris, ps.spheres, ps.planes,
                                 torch.as_tensor(o), torch.as_tensor(d),
                                 port_hit(jh))
    hit = np.asarray(jh.hit)
    assert hit.mean() > 0.5
    np.testing.assert_array_equal(psurf.hit.numpy(), hit)
    np.testing.assert_array_equal(psurf.material_id.numpy(),
                                  np.asarray(jsurf.material_id))
    # positions and normals are recomputed from the winner in float32;
    # the two packages round the same formulas in their own order
    for f in ("p", "n", "geo_n", "uv"):
        np.testing.assert_allclose(getattr(psurf, f).numpy(),
                                   np.asarray(getattr(jsurf, f)),
                                   rtol=1e-4, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("name", ["mixed", "sponza_lit"])
def test_shade_direct_matches_jax(name):
    """The same shading points shaded by both packages: Phong terms,
    the kd^2 quirk, and shadow rays (closest hit with refractive
    attenuation in the mixed scene, any-hit in sponza_proxy)."""
    js, jst, eye, ps, pst = scene_pair(name)
    o, d = rays_from(eye)
    jh = jax_hits(js, o, d)
    js_acc = j_attach(js)

    def jax_shade(o, d, h):
        s = j_surface.make_surface(js.tris, js.spheres, js.planes, o, d, h)
        s = s._replace(n=j_shading.apply_bump(js, jst, s))
        direct, tex, _ = j_shading.shade_direct(js_acc, jst, d, s,
                                                jax.random.key(0))
        return s, direct, tex

    jsurf, jdirect, jtex = jax.jit(jax_shade)(jnp.asarray(o), jnp.asarray(d),
                                              jh)
    psurf = surface.Surface(
        **{f: torch.as_tensor(np.array(getattr(jsurf, f)))
           for f in ("p", "n", "geo_n", "uv", "material_id", "hit")})
    pdirect, ptex, n_sh = shading.shade_direct(attach_accel(ps), pst,
                                               torch.as_tensor(d), psurf)
    assert n_sh == pst.num_lights
    np.testing.assert_array_equal(ptex.numpy(), np.asarray(jtex))
    jdirect = np.asarray(jdirect)
    close = np.isclose(pdirect.numpy(), jdirect, rtol=1e-4,
                       atol=1e-5).all(-1)
    # a shadow ray that leaves its surface at the terminator may go
    # either way on an ulp; allow one such ray
    assert (~close).sum() <= 1, np.argwhere(~close)[:5]
    lit = jdirect.max(-1) > 0
    assert lit.mean() > 0.2 and (~lit[np.asarray(jh.hit)]).any()


def test_reattach_rows_vjp_matches_jax():
    """ReattachRows' backward against jax.vjp of _reattach_rows: the
    scatter-add of the row cotangent into the (n_rows, 29) table, with
    repeated ids, sliced back into the ten per-field gradients."""
    rng = np.random.default_rng(SEED)
    n_rows, n = 200, 700
    ids = rng.integers(0, n_rows, n).astype(np.int32)
    widths = (3, 3, 3, 3, 3, 3, 3, 2, 2, 2)
    fields = [rng.normal(0, 1, (n_rows, w)).astype(np.float32)
              for w in widths]
    rows = rng.normal(0, 1, (n, 32)).astype(np.float32)
    g = rng.normal(0, 1, (n, 32)).astype(np.float32)

    out, vjp = jax.vjp(
        lambda rows, *f: j_surface._reattach_rows(n_rows, rows,
                                                  jnp.asarray(ids), *f),
        jnp.asarray(rows), *map(jnp.asarray, fields))
    j_grads = vjp(jnp.asarray(g))

    t_rows = torch.tensor(rows, requires_grad=True)
    t_fields = [torch.tensor(f, requires_grad=True) for f in fields]
    t_out = surface.ReattachRows.apply(t_rows, torch.as_tensor(ids), n_rows,
                                       *t_fields)
    np.testing.assert_array_equal(t_out.detach().numpy(), np.asarray(out))
    t_out.backward(torch.as_tensor(g))
    np.testing.assert_array_equal(t_rows.grad.numpy(),
                                  np.asarray(j_grads[0]))
    for k, (tf, jg) in enumerate(zip(t_fields, j_grads[1:])):
        np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-6, err_msg=str(k))


def test_reattached_rows_give_the_gather_gradients():
    """make_surface with the traversal's attribute rows gives the vertex,
    normal and uv gradients that gathering the rows from the pack gives."""
    js, jst, eye, ps, pst = scene_pair("mixed")
    ps = attach_accel(ps)
    o, d = (torch.as_tensor(x) for x in rays_from(eye))
    from cse168_raytracer_tpu_torch.ops.accel import scene_closest_hit
    hit, attr = scene_closest_hit(ps.accel, ps.spheres, ps.planes, o, d)
    assert bool((hit.prim_type == 1).any())
    grads = []
    for rows in (attr, None):
        pack = ps.tris.replace(**{
            f: getattr(ps.tris, f).clone().requires_grad_(True)
            for f in ("v0", "e1", "e2", "n0", "n1", "n2")})
        s = surface.make_surface(pack, ps.spheres, ps.planes, o, d, hit,
                                 tri_attr=rows)
        (s.p.sum() + (s.n * s.n).sum() + s.uv.sum()).backward()
        grads.append([getattr(pack, f).grad for f in
                      ("v0", "e1", "e2", "n0", "n1", "n2")])
    for a, b in zip(*grads):
        assert a.abs().sum() > 0
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
