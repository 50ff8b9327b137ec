"""The port's OBJ loader against the JAX package's, byte for byte.

Small OBJ files written under tmp_path (quads, `a//c`, `a/b`, `a/b/c`,
negative indices, faces without normals, comments, a CTM) are parsed by
JAX models/obj.load_obj and by the port's native parser (its own build
of csrc/objloader.cpp) and its plain Python parser: every array has the
same dtype, shape and bytes."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_golden  # noqa: E402,F401  (shares the cores between workers)

from cse168_raytracer_tpu.models import obj as jobj  # noqa: E402
from cse168_raytracer_tpu.scenes.registry import model_ctm  # noqa: E402
from cse168_raytracer_tpu_torch.models import obj as pobj  # noqa: E402
from cse168_raytracer_tpu_torch.ops import sah  # noqa: E402

FILES = {
    # quads (the first three tokens make the triangle), faces without
    # normals (generated, then averaged from (0, 1, 2)), a/b and a//c
    "mixed": """# a comment
o thing
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0.5
v 0.3 0.7 -1.25
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
vn 0.2 0.3 0.9
f 1 2 3 4
f 1/1 3/3 4/4
f 1//1 2//2 5//1
f 2/2/2 3/3/1 5/1/2
f 5 4 2
""",
    # negative (relative) indices are read as atoi reads them, unresolved:
    # vertex -3 becomes index -4 in both parsers
    "negative": """v 0 0 0
v 1 0 0
v 0 1 0
vt 0.5 0.5
vn 0 0 1
f -3//1 -2//1 -1//1
f 1/-1/1 2/-1/1 3/-1/1
""",
    # generated normals only, on a fan of shared vertices
    "fan": "\n".join(
        [f"v {np.cos(a):.9g} {np.sin(a):.9g} {0.1 * a:.9g}"
         for a in np.linspace(0, 6, 9)] + ["v 0 0 1"]
        + [f"f {i} {i + 1} 10" for i in range(1, 9)]) + "\n",
}
CTMS = {"identity": None,
        "ctm": model_ctm((1.0, -2.0, 0.5), 0.7, (2.0, 1.0, 0.5))}


def assert_same(a, b, what):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, (what, k)
        assert a[k].shape == b[k].shape, (what, k, a[k].shape, b[k].shape)
        assert a[k].tobytes() == b[k].tobytes(), (what, k)


@pytest.mark.parametrize("ctm", sorted(CTMS))
@pytest.mark.parametrize("name", sorted(FILES))
def test_obj_parsers_byte_equal(tmp_path, name, ctm):
    path = str(tmp_path / f"{name}.obj")
    with open(path, "w") as f:
        f.write(FILES[name])
    want = jobj.load_obj(path, CTMS[ctm])
    assert_same(want, pobj.load_obj(path, CTMS[ctm]), "native")
    assert_same(want, pobj.load_obj_plain(path, CTMS[ctm]), "plain")
    assert want["tri_vidx"].shape[0] >= 2


def test_make_ctm_matches_jax():
    for args in (((0, 0, 0), 0.0, 1.0), ((1, 2, 3), 0.3, (2, 3, 4))):
        assert (pobj.make_ctm(*args).tobytes()
                == jobj.make_ctm(*args).tobytes())


def test_missing_file_raises(tmp_path):
    missing = str(tmp_path / "none.obj")
    with pytest.raises(FileNotFoundError, match="none.obj"):
        pobj.load_obj(missing)
    with pytest.raises(FileNotFoundError):
        pobj.load_obj_plain(missing)


def test_loader_uses_the_ports_own_library():
    """load_obj binds the library of ops/sah.load_native (the port's
    _build/miniro-<hash>/libminiro.so), never csrc/libminiro.so."""
    lib = pobj._native()
    assert lib is sah.load_native()
    path = os.path.realpath(lib._name)
    assert path == os.path.realpath(sah.native_library_path())
    assert os.sep + "_build" + os.sep in path
    assert not path.endswith(os.path.join("csrc", "libminiro.so"))


def test_large_mesh_round_trip(tmp_path):
    """A 2,000-triangle mesh written with %.9g reads back to its float32
    vertices bit for bit (as chip_smoke.py's 159,960-triangle one)."""
    rng = np.random.default_rng(3)
    v = rng.normal(0, 5, (3000, 3)).astype(np.float32)
    f = rng.integers(0, 3000, (2000, 3))
    path = str(tmp_path / "big.obj")
    with open(path, "w") as fh:
        fh.writelines(f"v {x:.9g} {y:.9g} {z:.9g}\n" for x, y, z in v)
        fh.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in f)
    got = pobj.load_obj(path)
    assert got["vertices"].tobytes() == v.tobytes()
    np.testing.assert_array_equal(got["tri_vidx"], f)
    assert_same(got, pobj.load_obj_plain(path), "plain")
