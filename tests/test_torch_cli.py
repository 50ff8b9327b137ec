"""The port's command line, image writer, tonemaps and default device.

The command line runs in-process through cli.main on the CPU
(--device cpu) at 32x32. The PNG writer is read back with zlib and
struct alone; the tonemaps are held against the JAX package's."""

import struct
import sys
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cse168_raytracer_tpu.config import RenderConfig as JCfg  # noqa: E402
from cse168_raytracer_tpu.render import tonemap as jtm  # noqa: E402
from cse168_raytracer_tpu.scenes import build as jbuild  # noqa: E402
from cse168_raytracer_tpu_torch import cli  # noqa: E402
from cse168_raytracer_tpu_torch.config import RenderConfig  # noqa: E402
from cse168_raytracer_tpu_torch.render import image_io  # noqa: E402
from cse168_raytracer_tpu_torch.render import tonemap as ttm  # noqa: E402
from cse168_raytracer_tpu_torch.scenes import registry  # noqa: E402
from test_torch_golden import load_ppm  # noqa: E402


def read_png(path):
    """(H, W, 3) uint8, top-down, of an 8-bit RGB PNG with filter 0 on
    every row (what image_io.write_png writes); checks every CRC."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, size = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        if kind == b"IHDR":
            size = struct.unpack(">IIBBBBB", body)
            assert size[2:] == (8, 2, 0, 0, 0)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = size[:2]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def test_image_writers_round_trip(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3), np.uint8)
    image_io.write_image(str(tmp_path / "a.png"), img)
    image_io.write_image(str(tmp_path / "a.ppm"), img)
    # files store the rows top-down; the buffer's row 0 is the bottom
    np.testing.assert_array_equal(read_png(tmp_path / "a.png"), img[::-1])
    np.testing.assert_array_equal(load_ppm(tmp_path / "a.ppm"), img[::-1])


@pytest.mark.parametrize("kind", ["sigmoid", "normalized", "none"])
def test_tonemaps_match_jax(kind):
    hdr = np.random.default_rng(1).gamma(0.7, 0.6, (16, 16, 3)).astype(
        np.float32)
    hdr[0, 0, 0], hdr[1, 1, 1], hdr[2, 2, 2] = np.nan, np.inf, -0.5
    ours = ttm.tonemap(torch.as_tensor(hdr), kind).numpy()
    np.testing.assert_allclose(ours, np.asarray(jtm.tonemap(jnp.asarray(hdr),
                                                            kind)),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        ttm.tonemap(torch.as_tensor(hdr), "bogus")


def test_cli_render_on_cpu(tmp_path, capsys):
    """render --device cpu writes a PPM and a PNG of the same pixels,
    prints the [stats] lines, and its per-ray tests are the render's."""
    base = ["render", "--scene", "sponza_proxy", "--device", "cpu",
            "--width", "32", "--height", "32", "--depth", "4", "--stats"]
    assert cli.main(base + ["--out", str(tmp_path / "o.ppm")]) == 0
    # the render command's own function returns what it rendered
    res = cli.render(cli.parser().parse_args(
        base + ["--out", str(tmp_path / "o.png")]))
    err = capsys.readouterr().err
    for tag in ("[scene] built sponza_proxy on cpu", "[accel] built",
                "[render] first run", "[stats] primary=1024 ",
                "ray-box   tests/ray:", "ray-tri   tests/ray:", "[out] wrote"):
        assert tag in err, tag
    ppm, png = load_ppm(tmp_path / "o.ppm"), read_png(tmp_path / "o.png")
    np.testing.assert_array_equal(ppm, png)
    assert ppm.shape == (32, 32, 3)
    expect = ttm.to_bytes(ttm.sigmoid_tonemap(res["hdr"])).numpy()
    np.testing.assert_array_equal(png, expect[::-1])
    st = res["stats"]
    per_ray = int(st.box_tests) / res["rays"]
    assert per_ray > 0 and f"ray-box   tests/ray: {per_ray:8.2f}" in err
    assert res["device"] == torch.device("cpu")


@pytest.mark.parametrize("flag", ["--bench", "--no-photon-map"])
def test_cli_accepts_flags_without_effect(flag, tmp_path, capsys):
    """The JAX command line's --bench and --no-photon-map are accepted:
    the port always times a steady-state render, and renders no photon
    map without --photons."""
    assert cli.main(["render", "--scene", "sphere", "--device", "cpu",
                     "--width", "16", "--height", "16", "--depth", "2",
                     "--out", str(tmp_path / "x.ppm"), flag]) == 0
    assert "steady-state" in capsys.readouterr().err
    assert load_ppm(tmp_path / "x.ppm").shape == (16, 16, 3)


def test_cli_scenes(capsys):
    """`scenes` lists the JAX registry's 16 scenes."""
    from cse168_raytracer_tpu.scenes.registry import SCENES as JAX_SCENES
    assert cli.main(["scenes"]) == 0
    names = capsys.readouterr().out.split()
    assert names == sorted(JAX_SCENES) and len(names) == 16


CLI16 = ["--scene", "sphere", "--device", "cpu", "--width", "16",
         "--height", "16", "--depth", "2"]


def test_cli_sharded_equals_plain_render(tmp_path, capsys):
    """--sharded (one process, one shard) writes the plain render's
    image; --bench times a second, steady-state frame."""
    plain, shard = str(tmp_path / "p.ppm"), str(tmp_path / "s.ppm")
    assert cli.main(["render"] + CLI16 + ["--out", plain]) == 0
    res = cli.render(cli.parser().parse_args(
        ["render"] + CLI16 + ["--sharded", "--bench", "--out", shard]))
    err = capsys.readouterr().err
    assert "[mesh] 1 shard(s), one process; this is rank 0 on cpu" in err
    assert "[render] steady-state" in err and res["steady_s"] > 0
    assert res["rc"] == 0 and res["mesh"].n_shards == 1
    np.testing.assert_array_equal(load_ppm(shard), load_ppm(plain))


def two_ranks(tmp_path, extra, rc=0):
    """`cli render` of CLI16 + extra in two processes joined through
    --coordinator/--num-processes/--process-id; rank i writes
    r<i>.ppm. Returns their outputs."""
    from test_torch_parallel import free_port, run_ranks
    coord = f"127.0.0.1:{free_port()}"
    return run_ranks(lambda pid: [
        sys.executable, "-m", "cse168_raytracer_tpu_torch.cli", "render"]
        + CLI16 + extra + ["--coordinator", coord, "--num-processes", "2",
                           "--process-id", str(pid),
                           "--out", str(tmp_path / f"r{pid}.ppm")], 2, rc=rc)


def test_cli_sharded_height_must_divide(tmp_path):
    """Two processes, one shard each, and a height of 17: both exit 2
    with the JAX command line's message and write nothing."""
    outs = two_ranks(tmp_path, ["--height", "17", "--sharded"], rc=2)
    for o in outs:
        assert ("--height 17 must be divisible by the device count (2)"
                in o), o
    assert not list(tmp_path.glob("*.ppm"))


def test_cli_two_processes(tmp_path):
    """Two ranks joined by --coordinator/--num-processes/--process-id
    over gloo (the CPU's backend) render sharded without --sharded: rank
    0 writes the one-process 2-shard image, bit for bit, and rank 1
    writes nothing."""
    from cse168_raytracer_tpu_torch.parallel.sharding import (
        make_mesh, render_hdr_sharded)
    outs = two_ranks(tmp_path, [])
    assert "[mesh] 2 shard(s), 2 processes over gloo; this is rank 1" in outs[1]
    assert not (tmp_path / "r1.ppm").exists()
    scene, static, cam, cfg = registry.build(
        "sphere", RenderConfig(width=16, height=16, trace_depth=2),
        device="cpu")
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    with torch.no_grad():
        hdr = render_hdr_sharded(attach_accel(scene), static, cam, cfg,
                                 make_mesh(2, "cpu"))
    one = ttm.to_bytes(ttm.sigmoid_tonemap(hdr)).numpy()[::-1]
    np.testing.assert_array_equal(load_ppm(tmp_path / "r0.ppm"), one)


def test_cli_progressive_checkpoint_resume(tmp_path, capsys):
    """--progressive --checkpoint: a 2-sample run, then the 4-sample run
    resumes from its file and writes the straight run's image."""
    ckpt = str(tmp_path / "state.npz")
    base = ["render"] + CLI16 + ["--progressive", "--path-tracing"]
    assert cli.main(base + ["--spp", "4", "--out",
                            str(tmp_path / "full.ppm")]) == 0
    assert cli.main(base + ["--spp", "2", "--checkpoint", ckpt,
                            "--out", str(tmp_path / "half.ppm")]) == 0
    capsys.readouterr()
    assert cli.main(base + ["--spp", "4", "--checkpoint", ckpt,
                            "--out", str(tmp_path / "res.ppm")]) == 0
    assert "[progressive] resumed at 2/4 samples" in capsys.readouterr().err
    np.testing.assert_array_equal(load_ppm(tmp_path / "res.ppm"),
                                  load_ppm(tmp_path / "full.ppm"))


def test_cli_checkpoint_every(tmp_path, monkeypatch):
    from cse168_raytracer_tpu_torch.render import progressive
    saves = []
    monkeypatch.setattr(progressive, "save_render_state",
                        lambda p, a, done, seed: saves.append(done))
    assert cli.main(["render"] + CLI16 + [
        "--progressive", "--spp", "7", "--checkpoint",
        str(tmp_path / "c.npz"), "--checkpoint-every", "3",
        "--out", str(tmp_path / "x.ppm")]) == 0
    assert saves == [3, 6, 7]


def test_cli_view_writes_the_preview(tmp_path, capsys):
    out = tmp_path / "preview.ppm"
    assert cli.main(["view", "--scene", "sphere", "--device", "cpu",
                     "--width", "16", "--height", "16", "--spp", "3",
                     "--out", str(out)]) == 0
    err = capsys.readouterr().err
    assert "[view] 1/3 spp" in err and "[view] 3/3 spp" in err
    assert load_ppm(out).shape == (16, 16, 3) and load_ppm(out).any()


def test_cli_window_opens_the_viewer(monkeypatch):
    from cse168_raytracer_tpu_torch.render import viewer
    opened = []
    monkeypatch.setattr(viewer.InteractiveViewer, "main_loop",
                        lambda self: opened.append(self))
    assert cli.main(["window", "--scene", "sphere", "--device", "cpu",
                     "--width", "32", "--height", "24", "--depth", "3"]) == 0
    (v,) = opened
    assert (v.cfg.width, v.cfg.height, v.cfg.trace_depth) == (32, 24, 3)
    assert v.scene.accel is not None
    assert v.render_frame().shape == (24, 32, 3)


def test_cli_has_every_jax_option():
    """Every option of the JAX command line's render, view and window
    parsers parses in the port's."""
    import argparse
    from cse168_raytracer_tpu import cli as jcli
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, *a, **kw):
        seen["parser"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            jcli.main(["scenes"])
    finally:
        argparse.ArgumentParser.parse_args = real
    jsub = next(a for a in seen["parser"]._actions
                if isinstance(a, argparse._SubParsersAction))
    tsub = next(a for a in cli.parser()._actions
                if isinstance(a, argparse._SubParsersAction))
    assert set(jsub.choices) == set(tsub.choices)
    for cmd, jp in jsub.choices.items():
        flags = {f for a in tsub.choices[cmd]._actions for f in a.option_strings}
        for a in jp._actions:
            assert set(a.option_strings) <= flags, (cmd, a.option_strings)


def test_default_device_is_the_card(monkeypatch):
    """With no device given, the builders and the command line ask for
    the card; without one they raise and never render on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = RenderConfig(width=16, height=16)
    for name in sorted(registry.SCENES):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            registry.build(name, cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            registry.SCENES[name](cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["render", "--scene", "sphere"])
    scene, *_ = registry.build("sphere", cfg, device="cpu")
    assert scene.device == torch.device("cpu")


def _constructors():
    """Every public scene constructor, called as a scene author would,
    with (kwargs) to which the device is added."""
    from cse168_raytracer_tpu_torch import interop
    from cse168_raytracer_tpu_torch.models import geometry, lights, scene
    from cse168_raytracer_tpu_torch.models.materials import MaterialBuilder
    from cse168_raytracer_tpu_torch.models.textures import make_environment
    from cse168_raytracer_tpu_torch.ops import photon
    from cse168_raytracer_tpu_torch.render import camera
    z3 = np.zeros((128, 3), np.float32)
    z2 = np.zeros((128, 2), np.float32)
    tri = {"vertices": np.eye(3, dtype=np.float32),
           "normals": np.zeros((3, 3), np.float32),
           "texcoords": np.zeros((0, 2), np.float32),
           "tri_vidx": np.int32([[0, 1, 2]]), "tri_nidx": np.int32([[0, 1, 2]]),
           "tri_tidx": np.int32([[-1, -1, -1]])}
    cam = camera.make_camera((0, 0, 5), (0, 0, 0), device="cpu")
    cam_np = type("Cam", (), {k: getattr(cam, k).numpy() for k in (
        "eye", "view_dir", "up", "fov", "bg_color")})
    light = dict(kind=0, position=(0, 1, 0), color=(1, 1, 1), wattage=10.0)
    js, jst, _, _ = jbuild("test_sphere", JCfg(width=16, height=16))
    js = jax.tree.map(np.asarray, js)
    return {
        "make_scene": lambda **kw: scene.make_scene(**kw),
        "make_camera": lambda **kw: camera.make_camera((0, 0, 5), (0, 0, 0),
                                                       **kw),
        "camera_from_arrays": lambda **kw: camera.camera_from_arrays(
            (0, 0, 5), (0, 0, -1), (0, 1, 0), 45.0, (0, 0, 0), **kw),
        "make_light_table": lambda **kw: lights.make_light_table([light],
                                                                 **kw),
        "light_table_from_arrays": lambda **kw: lights.light_table_from_arrays(
            [0], [(0, 1, 0)], [(0, 1, 0)], [(1, 1, 1)], [10.0], [0.0],
            [(0, 0)], **kw),
        "MaterialBuilder.build": lambda **kw: MaterialBuilder().build(**kw),
        "pack_triangles": lambda **kw: geometry.pack_triangles([(tri, 0)],
                                                               **kw),
        "build_pack_from_arrays": lambda **kw: geometry.build_pack_from_arrays(
            z3, z3, z3, z3, z3, z3, z2, z2, z2, np.zeros(128, bool),
            np.zeros(128, np.int32), np.zeros(128, bool), **kw),
        "make_sphere_pool": lambda **kw: geometry.make_sphere_pool(
            [(0, 0, 0)], [1.0], [0], **kw),
        "make_plane_pool": lambda **kw: geometry.make_plane_pool(
            [(0, 0, 0)], [(0, 1, 0)], [0], **kw),
        "empty_sphere_pool": lambda **kw: geometry.empty_sphere_pool(**kw),
        "empty_plane_pool": lambda **kw: geometry.empty_plane_pool(**kw),
        "empty_triangle_pack": lambda **kw: geometry.empty_triangle_pack(**kw),
        "make_blpatch_pool": lambda **kw: geometry.make_blpatch_pool(
            [(0, 0, 0)], [(1, 0, 0)], [(0, 0, 1)], [(1, 1, 1)], [0], **kw),
        "empty_blpatch_pool": lambda **kw: geometry.empty_blpatch_pool(**kw),
        "make_environment": lambda **kw: make_environment(**kw),
        "interop.camera_from_numpy": lambda **kw: interop.camera_from_numpy(
            cam_np, **kw),
        "interop.scene_from_numpy": lambda **kw: interop.scene_from_numpy(
            js, jst, **kw),
        "build_grid": lambda **kw: photon.build_grid(
            z3, np.ones((128, 3), np.float32), z3, 0.5, **kw),
    }


def _tensors(obj):
    """The tensors of a constructor's result, through nested dataclasses
    and tuples."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [x for o in obj for x in _tensors(o)]
    if hasattr(obj, "__dict__"):
        return [x for o in vars(obj).values() for x in _tensors(o)]
    return []


CONSTRUCTORS = ("MaterialBuilder.build", "build_grid",
                "build_pack_from_arrays", "camera_from_arrays",
                "empty_blpatch_pool", "empty_plane_pool",
                "empty_sphere_pool", "empty_triangle_pack",
                "interop.camera_from_numpy", "interop.scene_from_numpy",
                "light_table_from_arrays", "make_blpatch_pool",
                "make_camera", "make_environment", "make_light_table",
                "make_plane_pool", "make_scene", "make_sphere_pool",
                "pack_triangles")


@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_constructors_default_to_the_card(monkeypatch, name):
    """Each scene constructor, given no device, asks for the card and
    raises without one; given device="cpu" it builds on the CPU."""
    makers = _constructors()
    assert sorted(makers) == list(CONSTRUCTORS)
    make = makers[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    tensors = _tensors(make(device="cpu"))
    assert tensors and all(x.device.type == "cpu" for x in tensors)
