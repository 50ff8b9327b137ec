"""The PyTorch port's host-side builds against the JAX package's, byte
for byte: triangle packing, the SAH build and leaf re-order, the W-wide
collapse, the leaf operand and attribute tables, and the asset-free
registry scenes."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import test_torch_golden  # noqa: E402,F401  (shares the cores between workers)

from cse168_raytracer_tpu.models import geometry as jgeo  # noqa: E402
from cse168_raytracer_tpu.ops import pallas_bvh as jpb  # noqa: E402
from cse168_raytracer_tpu.ops import sah as jsah  # noqa: E402
from cse168_raytracer_tpu_torch.models import geometry as tgeo  # noqa: E402
from cse168_raytracer_tpu_torch.ops import sah as tsah  # noqa: E402
from cse168_raytracer_tpu_torch.ops import wide_bvh as twb  # noqa: E402

PACK_FIELDS = ("v0", "e1", "e2", "n_geo", "n0", "n1", "n2", "t0", "t1", "t2",
               "has_uv", "material_id", "w6", "w4", "valid")


def random_mesh(n_tri, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 1, (n_tri * 3, 3)).astype(np.float32)
    f = np.arange(n_tri * 3, dtype=np.int64).reshape(n_tri, 3)
    return {"vertices": v,
            "normals": rng.normal(0, 1, (n_tri * 3, 3)).astype(np.float32),
            "texcoords": rng.uniform(0, 1, (n_tri * 3, 2)).astype(np.float32),
            "tri_vidx": f, "tri_nidx": f, "tri_tidx": f}


def clustered_mesh(n_tri, seed):
    """Small triangles around a few centres: a tree with real depth."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-5, 5, (12, 3))
    c = centres[rng.integers(0, 12, n_tri)] + rng.normal(0, 0.8, (n_tri, 3))
    v = (c[:, None, :] + rng.normal(0, 0.05, (n_tri, 3, 3))).reshape(-1, 3)
    f = np.arange(n_tri * 3, dtype=np.int64).reshape(n_tri, 3)
    return {"vertices": v.astype(np.float32),
            "normals": np.tile(np.float32([[0, 1, 0]]), (n_tri * 3, 1)),
            "texcoords": np.zeros((0, 2), np.float32), "tri_vidx": f,
            "tri_nidx": f, "tri_tidx": np.full((n_tri, 3), -1, np.int64)}


MESHES = {"tri1": lambda: random_mesh(1, 3), "tri33": lambda: random_mesh(33, 4),
          "tri80": lambda: random_mesh(80, 5),
          "tri3000": lambda: clustered_mesh(3000, 6)}


def ensure_native():
    """Load the native SAH builder in both packages. The JAX bridge
    caches a failed load and would then build a different tree: its
    csrc/libminiro.so may be mid-rebuild in another test worker, or this
    process may already hold a copy that the JAX package's OBJ loader
    built without the SAH builder (a later load of the same path returns
    that handle). Then it loads the port's build, from the same sources
    and flags, at its own path."""
    tsah.load_native()
    if jsah._load_lib() is False:
        jsah._CSRC = os.path.dirname(tsah.native_library_path())
        jsah._lib = None
    assert jsah._load_lib()


def assert_bytes_equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


def assert_pack_equal(jpack, tpack, fields=PACK_FIELDS):
    for f in fields:
        assert_bytes_equal(np.asarray(getattr(jpack, f)),
                           getattr(tpack, f).numpy(), f)


def two_packs(name):
    mesh = MESHES[name]()
    meshes = [(mesh, 2), (random_mesh(5, 9), 1)]
    return (jgeo.pack_triangles(meshes),
            tgeo.pack_triangles(meshes, device="cpu"))


@pytest.mark.parametrize("name", sorted(MESHES))
def test_pack_triangles_bytes(name):
    jpack, tpack = two_packs(name)
    assert_pack_equal(jpack, tpack)
    assert tpack.n_valid == int(np.asarray(jpack.valid).sum())


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sah_build_and_reorder_bytes(name):
    ensure_native()
    jpack, tpack = two_packs(name)
    jnew, jnodes, jleaves, jdepth = jsah.sah_build_and_reorder(
        jpack, twb.K, upload_plucker=False)
    tnew, tnodes, tleaves, tdepth = tsah.sah_build_and_reorder(
        tpack, twb.K, require_native=True)
    assert (jleaves, jdepth) == (tleaves, tdepth)
    assert_bytes_equal(jnodes, tnodes, "nodes")
    # the leaf order: every re-ordered per-triangle field
    assert_pack_equal(jnew, tnew)


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_wide_bvh_tables_bytes(name, width):
    """_collapse_wide (cbox, links, depth), _leafW_from_pack and
    _attrA_from_pack through the whole builder."""
    ensure_native()
    jpack, tpack = two_packs(name)
    jnew, jbvh = jpb.build_pallas_bvh4_sah(jpack, width=width)
    tnew, tbvh = twb.build_bvh4_sah(tpack, width=width)
    assert_pack_equal(jnew, tnew, [f for f in PACK_FIELDS
                                   if f not in ("w6", "w4")])
    assert tnew.w6 is None and jnew.w6 is None
    for f in ("cbox", "links", "leafW", "attrA"):
        assert_bytes_equal(np.asarray(getattr(jbvh, f)),
                           getattr(tbvh, f).numpy(), f)
    assert (jbvh.n_nodes, jbvh.n_leaves, jbvh.stack_depth) == \
        (tbvh.n_nodes, tbvh.n_leaves, tbvh.stack_depth)
    assert tbvh.width == width


@pytest.mark.parametrize("width", [4, 8])
def test_collapse_and_tables_direct(width):
    """The copied host functions called one by one on one tree."""
    ensure_native()
    jpack, tpack = two_packs("tri3000")
    jnew, jnodes, n_leaves, _ = jsah.sah_build_and_reorder(
        jpack, twb.K, upload_plucker=False)
    tnew, _, _, _ = tsah.sah_build_and_reorder(tpack, twb.K)
    jc = jpb._collapse_wide(jnodes.astype(np.float32), width)
    tc = twb._collapse_wide(jnodes.astype(np.float32), width)
    for a, b, what in zip(jc, tc, ("cbox", "links", "depth")):
        assert_bytes_equal(a, b, what)
    assert_bytes_equal(jpb._leafW_from_pack(jnew, n_leaves),
                       twb._leafW_from_pack(tnew.w6.numpy(), tnew.w4.numpy(),
                                            n_leaves), "leafW")
    assert_bytes_equal(jpb._attrA_from_pack(jnew, n_leaves),
                       twb._attrA_from_pack(tgeo.pack_host_arrays(tnew),
                                            n_leaves), "attrA")


def test_numpy_sah_builder_matches():
    """The numpy fallback builder gives the JAX fallback's tree."""
    jpack, tpack = two_packs("tri3000")
    lo = np.random.default_rng(0).uniform(-1, 0, (500, 3)).astype(np.float32)
    hi = lo + 0.1
    cent = (lo + hi) / 2
    for a, b in zip(jsah._sah_numpy(lo, hi, cent, 32),
                    tsah._sah_numpy(lo, hi, cent, 32)):
        assert_bytes_equal(a, b, "numpy sah")


def assert_scene_equal(js, jst, jcam, ts, tst, tcam):
    """The port's scene, static facts and camera hold the JAX package's
    arrays byte for byte (the camera's normalized view direction within
    1e-6: torch's and XLA's rsqrt may differ by an ulp)."""
    assert_pack_equal(js.tris, ts.tris)
    for pool, fields in (("spheres", ("center", "radius", "material_id",
                                      "valid")),
                         ("planes", ("origin", "normal", "material_id",
                                     "valid")),
                         ("materials", ("kd", "ks", "kt", "shininess", "ior",
                                        "texture_kind", "texture_params",
                                        "texture_color2", "image_id")),
                         ("lights", ("kind", "position", "normal", "color",
                                     "wattage", "radius", "dims"))):
        for f in fields:
            assert_bytes_equal(np.asarray(getattr(getattr(js, pool), f)),
                               getattr(getattr(ts, pool), f).numpy(),
                               f"{pool}.{f}")
    for f in ("rotation", "bg_color"):
        assert_bytes_equal(np.asarray(getattr(js.env, f)),
                           getattr(ts.env, f).numpy(), f"env.{f}")
    assert (js.env.cloud_params is None) == (ts.env.cloud_params is None)
    if js.env.cloud_params is not None:
        assert_bytes_equal(np.asarray(js.env.cloud_params),
                           ts.env.cloud_params.numpy(), "env.cloud_params")
    assert js.env.quirk_cloud_env_black == ts.env.quirk_cloud_env_black
    assert (js.env.image is None) == (ts.env.image is None)
    assert len(js.images) == len(ts.images)
    for a, b in zip(js.images, ts.images):
        for f in ("image", "lowres", "max_intensity"):
            assert_bytes_equal(np.asarray(getattr(a, f)),
                               getattr(b, f).numpy(), f"image.{f}")
    assert len(js.cellulars) == len(ts.cellulars)
    for a, b in zip(js.cellulars, ts.cellulars):
        assert a.halo == b.halo
        for f in ("points", "valid"):
            assert_bytes_equal(np.asarray(getattr(a, f)),
                               getattr(b, f).numpy(), f"cellular.{f}")
    assert tuple(jst.texture_kinds) == tst.texture_kinds
    assert (jst.any_bump, jst.num_lights, jst.any_refractive,
            jst.any_reflective) == (tst.any_bump, tst.num_lights,
                                    tst.any_refractive, tst.any_reflective)
    for f in ("eye", "up", "fov", "bg_color"):
        assert_bytes_equal(np.asarray(getattr(jcam, f)),
                           getattr(tcam, f).numpy(), f"camera.{f}")
    np.testing.assert_allclose(tcam.view_dir.numpy(),
                               np.asarray(jcam.view_dir), rtol=0, atol=1e-6)


@pytest.mark.parametrize("scene_name", [
    "sphere", "test_sphere", "sponza_proxy", "refract_spheres",
    "texture_plane", "cellular_plane", "spiral", "sponza"])
def test_registry_scene_arrays(scene_name):
    """Every asset-free registry scene, built by both packages."""
    from cse168_raytracer_tpu.config import RenderConfig as JCfg
    from cse168_raytracer_tpu.scenes import build as jbuild
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.scenes import build
    js, jst, jcam, _ = jbuild(scene_name, JCfg(width=16, height=16))
    ts, tst, tcam, _ = build(scene_name, RenderConfig(width=16, height=16),
                             device="cpu")
    assert_scene_equal(js, jst, jcam, ts, tst, tcam)


def test_interop_round_trip():
    """interop.scene_from_numpy keeps every array of the JAX scene."""
    from cse168_raytracer_tpu.config import RenderConfig as JCfg
    from cse168_raytracer_tpu.scenes import build as jbuild
    from cse168_raytracer_tpu_torch import interop
    js, jst, jcam, _ = jbuild("test_sphere", JCfg(width=16, height=16))
    ts, tst = interop.scene_from_numpy(jax.tree.map(np.asarray, js), jst,
                                       "cpu")
    tcam = interop.camera_from_numpy(jax.tree.map(np.asarray, jcam), "cpu")
    assert_pack_equal(js.tris, ts.tris)
    assert_bytes_equal(np.asarray(js.materials.kd), ts.materials.kd.numpy(),
                       "kd")
    assert_bytes_equal(np.asarray(jcam.view_dir), tcam.view_dir.numpy(),
                       "view_dir")
    assert ts.env.quirk_cloud_env_black and ts.env.cloud_params is not None
    assert tst.num_lights == 2 and tst.any_reflective
