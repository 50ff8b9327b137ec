"""The port's row-sharded rendering and training (parallel/) against
render_hdr, single-process gradients and the JAX package's sharded
functions, and a real two-process torch.distributed (gloo) job.

Whitted renders are deterministic, so a sharded render equals
render_hdr pixel for pixel (rtol 1e-5) and the two-process frame equals
the one-process frame of the same mesh bit for bit on the CPU. The
workers of the two-process tests are this file run as a script:

    python tests/test_torch_parallel.py worker <host:port> <n_proc> <pid> <out_dir>

Each subprocess gets communicate(timeout=300) and is killed on
timeout, so a hang fails the test instead of eating the suite's time.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import test_torch_golden  # noqa: E402,F401  (shares the cores between workers)

from cse168_raytracer_tpu_torch.config import RenderConfig  # noqa: E402
from cse168_raytracer_tpu_torch.parallel import distributed as dist  # noqa: E402
from cse168_raytracer_tpu_torch.parallel.sharding import (  # noqa: E402
    make_mesh, render_hdr_sharded, train_step_sharded)
from cse168_raytracer_tpu_torch.render.integrator import (  # noqa: E402
    render_hdr, render_hdr_band)
from cse168_raytracer_tpu_torch.scenes import build  # noqa: E402

RES = 16
N_PROC = 2
SHARDS_PER_PROC = 2
PHOTONS = 2000
PHOTON_SEED = 11


def sphere16():
    cfg = RenderConfig(width=RES, height=RES, trace_depth=2)
    scene, static, cam, cfg = build("sphere", cfg, device="cpu")
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    return attach_accel(scene), static, cam, cfg


def target():
    return torch.full((RES, RES, 3), 0.02)


def photon_batch(mesh):
    """chip_smoke's photon_box without its glass sphere, one sharded
    emission batch."""
    from chip_smoke import photon_scene
    from cse168_raytracer_tpu_torch.ops.photon import \
        trace_photon_batch_sharded
    scene, static, _ = photon_scene("cpu", glass=False)
    return trace_photon_batch_sharded(scene, static, 0, PHOTONS, False, 3,
                                      False, PHOTON_SEED, mesh)


def worker(coordinator, n_proc, pid, out_dir):
    """One rank: join over gloo, render the sharded frame, take a train
    step and trace a sharded photon batch; rank 0 writes the frame, every
    rank its new kd and loss."""
    rank = dist.init_multihost(coordinator, n_proc, pid, backend="gloo",
                               device="cpu")
    assert rank == pid and dist.init_multihost(coordinator, n_proc,
                                               pid) == pid   # idempotent
    mesh = dist.global_mesh(SHARDS_PER_PROC, "cpu")
    assert mesh.n_shards == n_proc * SHARDS_PER_PROC
    scene, static, cam, cfg = sphere16()
    with torch.no_grad():
        hdr = render_hdr_sharded(scene, static, cam, cfg, mesh)
    img = dist.gather_image(hdr, mesh)
    row0, n_rows = dist.process_tile_rows(RES, mesh)
    assert (row0, n_rows) == (pid * RES // n_proc, RES // n_proc)
    new, loss = train_step_sharded(scene, static, cam, cfg, mesh, target())
    out = photon_batch(dist.global_mesh(1, "cpu"))
    np.savez(os.path.join(out_dir, f"rank{pid}.npz"), img=img,
             kd=new.materials.kd.numpy(), loss=loss.numpy(),
             **{f"ph_{k}": getattr(out, k).numpy()
                for k in ("pos", "dir", "power", "mask", "bounces")})
    dist.shutdown()
    print(f"[worker {pid}] ok", flush=True)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(argv_of, n_proc, timeout=300, rc=0):
    """Start n_proc subprocesses (argv_of(pid)), wait for all; kill
    every one on a timeout. Returns their outputs; fails unless each
    exits with rc."""
    procs = [subprocess.Popen(argv_of(pid), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, cwd=ROOT)
             for pid in range(n_proc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == rc, f"rank {pid} exited {p.returncode}:\n{o}"
    return outs


@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    out = tmp_path_factory.mktemp("two_proc")
    coord = f"127.0.0.1:{free_port()}"
    outs = run_ranks(lambda pid: [sys.executable, os.path.abspath(__file__),
                                  "worker", coord, str(N_PROC), str(pid),
                                  str(out)], N_PROC)
    for pid, o in enumerate(outs):
        assert f"[worker {pid}] ok" in o, o
    return [dict(np.load(out / f"rank{pid}.npz")) for pid in range(N_PROC)]


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_render_equals_render_hdr(n):
    scene, static, cam, cfg = sphere16()
    with torch.no_grad():
        ref, _ = render_hdr(scene, static, cam, cfg)
        shd = render_hdr_sharded(scene, static, cam, cfg, make_mesh(n, "cpu"))
    assert float(ref.max()) > 0
    np.testing.assert_allclose(shd.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_sharded_path_traced_render_statistically():
    """Path tracing through the sharded spp loop: test_sphere at 32x32,
    8 samples, depth 2, over 2 shards, against render_hdr by
    test_torch_pathtrace.py's block-RMS bar (its seeds 0 and 1 give the
    estimator's noise; the shards draw other streams)."""
    from test_torch_pathtrace import blocks, rms
    cfg = RenderConfig(width=32, height=32, trace_depth=2, trace_samples=8,
                       path_tracing=True)
    scene, static, cam, cfg = build("test_sphere", cfg, device="cpu")
    with torch.no_grad():
        ref = [blocks(render_hdr(scene, static, cam, cfg.replace(seed=k))[0]
                      .numpy()) for k in (0, 1)]
        shd = render_hdr_sharded(scene, static, cam, cfg, make_mesh(2, "cpu"))
    assert torch.isfinite(shd).all()
    err, tol = rms(blocks(shd.numpy()), ref[0]), 3.0 * rms(*ref) + 1.0
    assert err <= tol, (err, tol)


def test_sharded_render_matches_jax():
    """The port's 4-shard frame against the JAX package's
    render_hdr_sharded over its 4-device CPU mesh (same scene, through
    interop), at tests/test_golden.py's bar: a port-vs-JAX render, where
    an ulp decides a pixel at a shadow terminator (here one pixel of
    256 is 6e-6 in one package and 0 in the other), as in
    test_torch_render.py."""
    import jax
    from cse168_raytracer_tpu.config import RenderConfig as JCfg
    from cse168_raytracer_tpu.parallel.sharding import \
        make_mesh as j_make_mesh
    from cse168_raytracer_tpu.parallel.sharding import \
        render_hdr_sharded as j_sharded
    from cse168_raytracer_tpu.scenes import build as j_build
    from test_torch_render import port_inputs
    js, jst, jcam, jcfg = j_build("sphere", JCfg(width=RES, height=RES,
                                                 trace_depth=2))
    mesh = j_make_mesh(4)
    jimg = np.asarray(jax.jit(lambda s, c, k: j_sharded(
        s, jst, c, jcfg, k, mesh))(js, jcam, jax.random.key(0)))
    ps, pst, pcam = port_inputs(js, jst, jcam)
    cfg = RenderConfig(width=RES, height=RES, trace_depth=2)
    with torch.no_grad():
        img = render_hdr_sharded(ps, pst, pcam, cfg, make_mesh(4, "cpu"))
    from test_torch_blpatch import golden_bar
    golden_bar(img.numpy(), jimg)
    assert np.isclose(img.numpy(), jimg, rtol=1e-5, atol=1e-6).all(
        -1).mean() >= 0.99


def test_train_step_reduces_loss():
    scene, static, cam, cfg = sphere16()
    mesh = make_mesh(4, "cpu")
    losses = []
    for _ in range(3):
        scene, loss = train_step_sharded(scene, static, cam, cfg, mesh,
                                         target(), lr=0.5)
        losses.append(float(loss))
    assert losses[2] < losses[0], losses


def test_train_step_grads_equal_single_process():
    """The sharded step's update equals the one from the full frame's
    gradient (one render_hdr, torch autograd) at rtol 1e-5, for 1, 2 and
    4 shards, and the loss is the frame's mean."""
    scene, static, cam, cfg = sphere16()
    kd = scene.materials.kd.clone().requires_grad_(True)
    hdr, _ = render_hdr(scene.replace(materials=scene.materials.replace(
        kd=kd)), static, cam, cfg)
    ref_loss = ((hdr - target()) ** 2).mean()
    ref_loss.backward()
    ref_kd = scene.materials.kd - 1e-2 * kd.grad
    assert kd.grad.abs().sum() > 0
    for n in (1, 2, 4):
        new, loss = train_step_sharded(scene, static, cam, cfg,
                                       make_mesh(n, "cpu"), target())
        np.testing.assert_allclose(new.materials.kd.numpy(), ref_kd.numpy(),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(loss), ref_loss.item(), rtol=1e-5)


def test_train_step_matches_jax():
    """The new kd of one step against the JAX package's
    train_step_sharded on a 4-device mesh, rtol 1e-5."""
    import jax
    import jax.numpy as jnp
    from cse168_raytracer_tpu.config import RenderConfig as JCfg
    from cse168_raytracer_tpu.parallel.sharding import \
        make_mesh as j_make_mesh
    from cse168_raytracer_tpu.parallel.sharding import \
        train_step_sharded as j_step
    from cse168_raytracer_tpu.scenes import build as j_build
    from test_torch_render import port_inputs
    js, jst, jcam, jcfg = j_build("sphere", JCfg(width=RES, height=RES,
                                                 trace_depth=2))
    mesh = j_make_mesh(4)
    jnew, jloss = jax.jit(lambda s, k: j_step(
        s, jst, jcam, jcfg, k, mesh, jnp.full((RES, RES, 3), 0.02)))(
        js, jax.random.key(0))
    ps, pst, pcam = port_inputs(js, jst, jcam)
    cfg = RenderConfig(width=RES, height=RES, trace_depth=2)
    new, loss = train_step_sharded(ps, pst, pcam, cfg, make_mesh(4, "cpu"),
                                   target())
    for f in ("kd", "ks", "kt"):
        np.testing.assert_allclose(getattr(new.materials, f).numpy(),
                                   np.asarray(getattr(jnew.materials, f)),
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_process_tile_rows_and_single_process_mesh():
    assert dist.init_multihost() == 0
    mesh = dist.global_mesh(4, "cpu")
    assert (mesh.n_shards, mesh.local_shards, mesh.group) == (4, (0, 1, 2, 3),
                                                              None)
    assert dist.process_tile_rows(16, mesh) == (0, 16)
    part = dist.Mesh(8, (2, 3), None, torch.device("cpu"))
    assert dist.process_tile_rows(16, part) == (4, 4)
    with pytest.raises(ValueError, match="not contiguous"):
        dist.process_tile_rows(16, dist.Mesh(8, (1, 3), None,
                                             torch.device("cpu")))
    with pytest.raises(ValueError, match="divide"):
        dist.process_tile_rows(18, mesh)
    scene, static, cam, cfg = sphere16()
    with pytest.raises(ValueError, match="divide over 3"):
        render_hdr_sharded(scene, static, cam, cfg, make_mesh(3, "cpu"))
    img = torch.arange(12.0).reshape(2, 2, 3)
    np.testing.assert_array_equal(dist.gather_image(img, mesh), img.numpy())


@pytest.mark.parametrize("rows", [8, 16])
def test_render_hdr_band_stacked_equals_render_hdr(rows):
    cfg = RenderConfig(width=32, height=32, trace_depth=3)
    scene, static, cam, cfg = build("test_sphere", cfg, device="cpu")
    with torch.no_grad():
        ref, _ = render_hdr(scene, static, cam, cfg)
        bands = [render_hdr_band(scene, static, cam, cfg, None, y0, rows)[0]
                 for y0 in range(0, 32, rows)]
    np.testing.assert_allclose(torch.cat(bands).numpy(), ref.numpy(),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="16x8"):
        render_hdr_band(scene, static, cam, cfg, None, 0, 4)


def test_photon_batch_shards_reassemble():
    """Two local shards trace ceil(n / 2) photons each from their own
    streams; the slabs follow in shard order and the bounces add up."""
    from chip_smoke import photon_scene
    from cse168_raytracer_tpu_torch.core.sampling import stream
    from cse168_raytracer_tpu_torch.ops.photon import draw_trace_photon_batch
    out = photon_batch(make_mesh(2, "cpu"))
    scene, static, _ = photon_scene("cpu", glass=False)
    half = PHOTONS // 2
    parts = [draw_trace_photon_batch(scene, static, 0, half, False, 3, False,
                                     stream(PHOTON_SEED, s, "cpu"))
             for s in (0, 1)]
    assert out.pos.shape == (4, PHOTONS, 3) and out.mask.any()
    for k in ("pos", "dir", "power", "mask"):
        torch.testing.assert_close(getattr(out, k), torch.cat(
            [getattr(p, k) for p in parts], 1), rtol=0, atol=0)
    assert torch.equal(out.bounces, parts[0].bounces + parts[1].bounces)


def test_build_photon_maps_over_a_mesh():
    """build_photon_maps(mesh=...) rounds its batches to the shard count
    and stores its target."""
    from chip_smoke import photon_scene
    from cse168_raytracer_tpu_torch.ops.photon import build_photon_maps
    scene, static, _ = photon_scene("cpu", glass=False)
    cfg = RenderConfig(photons_per_light=3000, caustic_photons_per_light=0)
    gen = torch.Generator().manual_seed(0)
    maps, st = build_photon_maps(scene, static, cfg, gen, return_stats=True,
                                 mesh=make_mesh(3, "cpu"))
    assert st["global"]["emitted"] % 10002 == 0
    assert maps.global_map.n_valid == 3000 and maps.caustic_map is None


# ---------------------------------------------------------------------------
# two processes over gloo
# ---------------------------------------------------------------------------

def test_two_process_frame_equals_one_process_mesh(two_process):
    """2 processes x 2 shards == one process's 4-shard mesh, bit for
    bit."""
    scene, static, cam, cfg = sphere16()
    with torch.no_grad():
        ref = render_hdr_sharded(scene, static, cam, cfg, make_mesh(4, "cpu"))
    np.testing.assert_array_equal(two_process[0]["img"], ref.numpy())


def test_two_process_grads_equal_on_every_rank(two_process):
    """Every rank takes the same step, equal to the one-process 4-shard
    step at rtol 1e-5 (the gradient sums in another order)."""
    np.testing.assert_array_equal(two_process[0]["kd"], two_process[1]["kd"])
    np.testing.assert_array_equal(two_process[0]["loss"],
                                  two_process[1]["loss"])
    scene, static, cam, cfg = sphere16()
    new, loss = train_step_sharded(scene, static, cam, cfg,
                                   make_mesh(4, "cpu"), target())
    np.testing.assert_allclose(two_process[0]["kd"], new.materials.kd.numpy(),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(two_process[0]["loss"], float(loss),
                               rtol=1e-5)


def test_two_process_photon_emission(two_process):
    """The two ranks' emission (2 processes, one shard each) == one
    process's 2 local shards, bit for bit, on both ranks."""
    ref = photon_batch(make_mesh(2, "cpu"))
    for r in two_process:
        for k in ("pos", "dir", "power", "mask", "bounces"):
            np.testing.assert_array_equal(r[f"ph_{k}"],
                                          getattr(ref, k).numpy())


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
