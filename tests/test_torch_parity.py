"""The port has every public top-level name of the JAX package's modules.

1. An `ast` scan: for each module of cse168_raytracer_tpu, every public
   top-level name it defines (functions, classes, assignments) is
   defined in the port's module at the same path, but for the listed
   exceptions, each with its reason.
2. The names ported for that on seeded inputs against the JAX functions:
   vecmath's length, length2 and offset_ray_origin (rtol 1e-6: XLA may
   sum and fuse in another order), accel_closest_hit, bvh_closest_hit,
   bvh_any_hit, packet_closest_hit and packet_any_hit on a clustered
   mesh with a sphere and a plane (hit masks, kinds and occlusion equal,
   t within rtol 1e-5, ids equal but at ties, as
   test_torch_accel_kinds.py holds the traversals), detach_tri_hit
   (the brute-force hit against JAX's, no gradient), Mesh's fields,
   UVW_KINDS and INF.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_parity.py -q
"""

import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import test_torch_golden  # noqa: E402,F401  (shares the cores between workers)
from test_torch_accel_kinds import (BIG, RTOL, assert_hits_match,  # noqa: E402
                                    kind_pair, morton_packs, packs,
                                    scene_rays)

from cse168_raytracer_tpu.core import vecmath as jvm  # noqa: E402
from cse168_raytracer_tpu.models import geometry as jgeo  # noqa: E402
from cse168_raytracer_tpu.models import materials as jmat  # noqa: E402
from cse168_raytracer_tpu.ops import accel as jacc  # noqa: E402
from cse168_raytracer_tpu.ops import bvh as jbvh  # noqa: E402
from cse168_raytracer_tpu.ops import intersect as jint  # noqa: E402
from cse168_raytracer_tpu.ops import packet as jpkt  # noqa: E402
from cse168_raytracer_tpu.scenes import registry as jreg  # noqa: E402
from cse168_raytracer_tpu_torch.core import vecmath as tvm  # noqa: E402
from cse168_raytracer_tpu_torch.models import geometry as tgeo  # noqa: E402
from cse168_raytracer_tpu_torch.models import materials as tmat  # noqa: E402
from cse168_raytracer_tpu_torch.ops import accel as tacc  # noqa: E402
from cse168_raytracer_tpu_torch.ops import bvh as tbvh  # noqa: E402
from cse168_raytracer_tpu_torch.ops import intersect as tint  # noqa: E402
from cse168_raytracer_tpu_torch.ops import packet as tpkt  # noqa: E402
from cse168_raytracer_tpu_torch.scenes import registry as treg  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "cse168_raytracer_tpu")
PORT_PKG = os.path.join(ROOT, "cse168_raytracer_tpu_torch")

# names of the JAX package the port does not define, and why
NAME_EXCEPTIONS = {
    ("core/fastgather.py", "ONEHOT_MAX_ROWS"):
        "the TPU's threshold between a one-hot matmul gather and a take; "
        "the port always gathers directly",
    ("utils/profiling.py", "device_trace"):
        "jax.profiler's trace capture; the port's spans and phases are "
        "events of whatever torch.profiler session a caller opens",
}
# modules without a port module at their path: the Pallas kernels, ported
# by hand into these modules (ROADMAP.md queue B)
MODULE_EXCEPTIONS = {
    "ops/pallas_bvh.py": ("ops/wide_bvh.py", "ops/binary_bvh.py",
                          "ops/forest.py"),
    "ops/pallas_intersect.py": ("ops/tri_blocks.py",),
}


def public_names(path):
    """The public names a module defines at its top level."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {n.id for t in node.targets for n in ast.walk(t)
                    if isinstance(n, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


def jax_modules():
    for root, _, files in os.walk(JAX_PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(root, f), JAX_PKG)


def test_every_jax_module_has_its_port_module():
    missing = [m for m in jax_modules() if m not in MODULE_EXCEPTIONS
               and not os.path.exists(os.path.join(PORT_PKG, m))]
    assert not missing
    for ports in MODULE_EXCEPTIONS.values():
        assert all(os.path.exists(os.path.join(PORT_PKG, p)) for p in ports)


def test_every_public_name_is_ported():
    missing = []
    for m in jax_modules():
        if m in MODULE_EXCEPTIONS:
            continue
        port = public_names(os.path.join(PORT_PKG, m))
        missing += [(m, n) for n in sorted(public_names(os.path.join(
            JAX_PKG, m)) - port) if (m, n) not in NAME_EXCEPTIONS]
    assert not missing
    # every exception still names a JAX name the port lacks
    for m, n in NAME_EXCEPTIONS:
        assert n in public_names(os.path.join(JAX_PKG, m))
        assert n not in public_names(os.path.join(PORT_PKG, m))


def test_vecmath_names_match_jax():
    rng = np.random.default_rng(0)
    a = (rng.normal(0, 1, (4096, 3))
         * np.exp(rng.uniform(-8, 8, (4096, 1)))).astype(np.float32)
    d = rng.normal(0, 1, (4096, 3)).astype(np.float32)
    t, td = torch.as_tensor(a), torch.as_tensor(d)
    for port, jax_ in ((tvm.length2(t), jvm.length2(jnp.asarray(a))),
                       (tvm.length(t), jvm.length(jnp.asarray(a))),
                       (tvm.offset_ray_origin(t, td),
                        jvm.offset_ray_origin(jnp.asarray(a),
                                              jnp.asarray(d)))):
        np.testing.assert_allclose(port.numpy(), np.asarray(jax_),
                                   rtol=1e-6, atol=0)
    wide = rng.normal(0, 1, (64, 5)).astype(np.float32)
    np.testing.assert_allclose(tvm.length2(torch.as_tensor(wide)).numpy(),
                               np.asarray(jvm.length2(jnp.asarray(wide))),
                               rtol=1e-6)


def test_constants_and_mesh_match_jax():
    assert tmat.UVW_KINDS == jmat.UVW_KINDS
    assert treg.INF == jreg.INF == float("inf")
    assert tgeo.Mesh._fields == jgeo.Mesh._fields
    rng = np.random.default_rng(1)
    arrays = dict(vertices=rng.normal(size=(5, 3)), normals=rng.normal(
        size=(5, 3)), texcoords=np.zeros((0, 2)), tri_vidx=np.arange(6)
        .reshape(2, 3) % 5, tri_nidx=np.arange(6).reshape(2, 3) % 5,
        tri_tidx=-np.ones((2, 3)))
    mesh = tgeo.Mesh(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    assert torch.equal(mesh.tri_vidx, torch.as_tensor(arrays["tri_vidx"]))


def pools():
    """(JAX spheres, planes), (port spheres, planes): a sphere inside the
    clustered mesh's box and a plane behind it."""
    args = ([[0.2, -0.1, 0.3]], [0.6], [0]), ([[0, 0, 4]], [[0, 0, -1]], [0])
    return ((jgeo.make_sphere_pool(*args[0]), jgeo.make_plane_pool(*args[1])),
            (tgeo.make_sphere_pool(*args[0], device="cpu"),
             tgeo.make_plane_pool(*args[1], device="cpu")))


PORTED = {"block": (jacc.accel_closest_hit, tacc.accel_closest_hit, None,
                    None),
          "bvh": (jbvh.bvh_closest_hit, tbvh.bvh_closest_hit,
                  jbvh.bvh_any_hit, tbvh.bvh_any_hit),
          "packet": (jpkt.packet_closest_hit, tpkt.packet_closest_hit,
                     jpkt.packet_any_hit, tpkt.packet_any_hit)}


@pytest.mark.parametrize("kind", sorted(PORTED))
def test_scene_hits_match_jax(kind):
    jclosest, tclosest, jany, tany = PORTED[kind]
    jaccel, taccel, tpack = kind_pair("clustered", kind)
    jpack = morton_packs("clustered")[2]     # the rows the accelerators hold
    (js, jp), (ts, tp) = pools()
    r = scene_rays("clustered", 5)
    jr = [jnp.asarray(x) for x in r]
    tr = [torch.as_tensor(x) for x in r]
    jh = jclosest(jaccel, jpack, js, jp, *jr)
    th = tclosest(taccel, tpack, ts, tp, *tr)
    jt = np.where(np.asarray(jh.hit), np.asarray(jh.t), BIG)
    tt = np.where(th.hit.numpy(), th.t.numpy(), BIG)
    hit = assert_hits_match(tt, th.prim_id.numpy(), jt,
                            np.asarray(jh.prim_id))
    np.testing.assert_array_equal(th.prim_type.numpy()[hit],
                                  np.asarray(jh.prim_type)[hit])
    assert hit.any() and (np.asarray(jh.prim_type) == 2).any()
    if jany is not None:
        np.testing.assert_array_equal(
            tany(taccel, tpack, ts, tp, *tr).numpy(),
            np.asarray(jany(jaccel, jpack, js, jp, *jr)))


def test_detach_tri_hit_matches_jax():
    jpack, tpack = packs("clustered")
    r = scene_rays("clustered", 6)
    jh = jint.detach_tri_hit(jint._intersect_triangles_impl, jpack,
                             *(jnp.asarray(x) for x in r))
    o, d, tmin, tmax = (torch.as_tensor(x) for x in r)
    o.requires_grad_(True)
    th = tint.detach_tri_hit(tint.intersect_triangles, tpack, o, d, tmin,
                             tmax)
    assert not th.t.requires_grad
    jt = np.where(np.asarray(jh.hit), np.asarray(jh.t), BIG)
    tt = np.where(th.hit.numpy(), th.t.numpy(), BIG)
    np.testing.assert_array_equal(tt < BIG, jt < BIG)
    np.testing.assert_allclose(tt[tt < BIG], jt[jt < BIG], rtol=RTOL)
