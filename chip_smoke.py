#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds
it against its plain PyTorch twin on the card, drives the port's main
path (sponza_proxy at 512x512, trace depth 4, forward and backward of
sum(render_hdr) with respect to the material table kd, as bench.py does
for the JAX package; once as registered and once with its light moved
inside the atrium, see lit_sponza), checks the card's renders against the CPU's,
and times the kernel against the twin. Each phase prints its own lines;
any failure raises and exits non-zero. The second-to-last line is a
JSON object describing each kernel; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it fails at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

DEPTH = 4
RES = 512
N_SUBSET = 8192
SEED = 0
PLAIN_BUDGET_S = 60.0
PLAIN_SUBSET = 16384
TOL = dict(rtol=1e-4, atol=1e-5)
LIT_LIGHT = (0.0, 8.0, 0.0)


def log(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# scenes and rays
# ---------------------------------------------------------------------------

def box_mesh(boxes):
    """Triangle mesh of axis-aligned boxes (cx, cy, cz, sx, sy, sz) with
    per-corner face normals, in models/geometry's mesh-dict form."""
    verts, tris = [], []
    faces = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5),
             (0, 5, 1), (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4),
             (1, 5, 7), (1, 7, 3)]
    for cx, cy, cz, sx, sy, sz in boxes:
        base = len(verts)
        for dx in (-sx, sx):
            for dy in (-sy, sy):
                for dz in (-sz, sz):
                    verts.append((cx + dx, cy + dy, cz + dz))
        tris += [(base + a, base + b, base + c) for a, b, c in faces]
    v = np.asarray(verts, np.float32)
    f = np.asarray(tris, np.int32)
    n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    return {"vertices": v, "normals": np.repeat(n, 3, 0).astype(np.float32),
            "texcoords": np.zeros((0, 2), np.float32), "tri_vidx": f,
            "tri_nidx": np.arange(f.size, dtype=np.int32).reshape(-1, 3),
            "tri_tidx": np.full_like(f, -1)}


def mixed_spec():
    """Boxes (a procedural mesh), a mirror sphere and a refractive
    sphere on a checkered floor plane under two point lights, as plain
    data: it runs the child rays, the compaction and the closest-hit
    shadows with attributes that sponza_proxy does not. Materials are
    MaterialBuilder calls (method, kwargs) in id order."""
    rng = np.random.RandomState(SEED)
    boxes = [(rng.uniform(-3, 3), s, rng.uniform(-3, 2), s, s, s)
             for s in rng.uniform(0.1, 0.4, 24)]
    return {
        "mesh": box_mesh(boxes), "mesh_material": 0,
        "materials": [
            ("phong", dict(kd=(0.8, 0.7, 0.6))),
            ("phong", dict(kd=(0.2, 0.2, 0.2), ks=(0.7, 0.7, 0.7),
                           shininess=50)),
            ("phong", dict(kd=(0.0, 0.0, 0.0), kt=(0.9, 0.9, 0.9),
                           shininess=100, ior=1.5)),
            ("textured", dict(kind=1, params=[1.0], color1=(0.9, 0.9, 0.9),
                              color2=(0.1, 0.3, 0.1))),
        ],
        "spheres": ([(-1.2, 1.0, 0.0), (1.2, 0.8, 0.8)], [1.0, 0.8], [1, 2]),
        "planes": ([(0, 0, 0)], [(0, 1, 0)], [3]),
        "lights": [dict(kind=0, position=(3, 8, 5), color=(1, 1, 1),
                        wattage=900.0),
                   dict(kind=0, position=(-4, 6, 2), color=(1, 1, 1),
                        wattage=400.0)],
        "camera": dict(eye=(0, 3, 7), look_at=(0, 0.5, 0), fov=45),
    }


def mixed_scene(device):
    """The port's Scene, SceneStatic and Camera of mixed_spec()."""
    from cse168_raytracer_tpu_torch.models.geometry import (make_plane_pool,
                                                            make_sphere_pool,
                                                            pack_triangles)
    from cse168_raytracer_tpu_torch.models.materials import MaterialBuilder
    from cse168_raytracer_tpu_torch.models.scene import make_scene
    from cse168_raytracer_tpu_torch.render.camera import make_camera
    spec = mixed_spec()
    mb = MaterialBuilder()
    for method, kw in spec["materials"]:
        getattr(mb, method)(**kw)
    scene, static = make_scene(
        tris=pack_triangles([(spec["mesh"], spec["mesh_material"])],
                            device=device),
        spheres=make_sphere_pool(*spec["spheres"], device),
        planes=make_plane_pool(*spec["planes"], device),
        materials=mb.build(device), lights=spec["lights"], device=device)
    return scene, static, make_camera(**spec["camera"], device=device)


def random_mesh(n_tri, rng):
    v = rng.normal(0, 1, (n_tri * 3, 3)).astype(np.float32)
    f = np.arange(n_tri * 3, dtype=np.int64).reshape(n_tri, 3)
    return {"vertices": v,
            "normals": np.tile(np.float32([[0, 0, 1]]), (n_tri * 3, 1)),
            "texcoords": np.zeros((0, 2), np.float32), "tri_vidx": f,
            "tri_nidx": f, "tri_tidx": np.full((n_tri, 3), -1, np.int64)}


def primary_rays(cam, width, height, device):
    """All pinhole rays of a frame in the integrator's block order."""
    import torch
    from cse168_raytracer_tpu_torch.render.camera import eye_rays
    from cse168_raytracer_tpu_torch.render.integrator import block_ray_order
    xs, ys = block_ray_order(width, height)
    o, d = eye_rays(cam, torch.tensor(xs, device=device),
                    torch.tensor(ys, device=device), width, height)
    return o.contiguous(), d.contiguous()


def shadow_rays(scene, o, d):
    """Shadow rays toward light 0 from the closest hits of (o, d), as
    ops/shading.py casts them; missing rays get tmax = -1."""
    import torch
    from cse168_raytracer_tpu_torch.config import EPSILON
    from cse168_raytracer_tpu_torch.ops.wide_bvh import closest_hit_triangles
    t = closest_hit_triangles(scene.accel, o, d, 0.0, 1e12)[0]
    hit = t < 3e37
    p = o + torch.where(hit, t, 1.0)[:, None] * d
    lv = scene.lights.position[0] - p
    dist = lv.norm(dim=-1)
    ld = (lv / dist[:, None]).contiguous()
    return ((p + ld * EPSILON).contiguous(), ld,
            torch.where(hit, dist, -1.0).contiguous())


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def compare_traversal(label, bvh, o, d, tmin, tmax, errs):
    """Kernel against twin on the card, closest+attr and any-hit, at the
    bar of tests/test_bvh.py::_check_against_brute plus bit-equal
    attribute rows where the ids agree and equal any-hit masks."""
    import torch
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    t, ids, attr = wb.closest_hit_triangles(bvh, o, d, tmin, tmax)
    tp, idp, attrp = wb.closest_hit_triangles_plain(bvh, o, d, tmin, tmax)
    occ = wb.any_hit_triangles(bvh, o, d, tmin, tmax) < 3e37
    occp = wb.any_hit_triangles_plain(bvh, o, d, tmin, tmax) < 3e37
    torch.cuda.synchronize()
    hit, hitp = t < 3e37, tp < 3e37
    if not torch.equal(hit, hitp):
        raise AssertionError(f"{label}: hit masks differ on "
                             f"{int((hit != hitp).sum())} rays")
    both = hit & hitp
    torch.testing.assert_close(t[both], tp[both], **TOL)
    same = both & (ids == idp)
    agree = float(same.sum()) / max(int(both.sum()), 1)
    if agree <= 0.99:
        raise AssertionError(f"{label}: ids agree on {agree:.4f} of hits")
    if not torch.equal(attr[same], attrp[same]):
        raise AssertionError(f"{label}: attribute rows differ")
    if not torch.equal(attr[~hit], torch.zeros_like(attr[~hit])):
        raise AssertionError(f"{label}: miss rows are not zero")
    if not torch.equal(occ, occp) or not torch.equal(occ, hitp):
        raise AssertionError(f"{label}: any-hit masks differ")
    err = float((t[both] - tp[both]).abs().max()) if both.any() else 0.0
    errs["closest"] = max(errs["closest"], err)
    errs["any"] = max(errs["any"], float((occ != occp).float().max()))
    log(f"  {label}: W={bvh.width} rays={o.shape[0]} hits={int(hit.sum())} "
        f"occluded={int(occ.sum())} max|dt|={err:.3g} id_agree={agree:.5f} "
        f"bit_equal_t={bool(torch.equal(t[both], tp[both]))}")


def time_cuda(fn, reps, warm=True):
    """Mean milliseconds of fn() over `reps` calls, by CUDA events,
    after one untimed call when `warm`."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fwd_bwd(scene, static, cam, cfg):
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    kd = scene.materials.kd.detach().clone().requires_grad_(True)
    s = scene.replace(materials=scene.materials.replace(kd=kd))
    hdr, stats = render_hdr(s, static, cam, cfg)
    hdr.sum().backward()
    return hdr.detach(), kd.grad, stats


def pixel_agreement(a, b):
    """Share of pixels whose three channels agree at TOL."""
    import torch
    close = torch.isclose(a, b, **TOL).all(-1)
    return float(close.float().mean())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[1 device]", torch.cuda.get_device_name(0),
        f"count={torch.cuda.device_count()}",
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    log(card)
    return torch.device("cuda:0"), card


def phase_build():
    from cse168_raytracer_tpu_torch.ops import cuda_build, sah, wide_bvh
    t0 = time.perf_counter()
    wide_bvh._kernel_lib()
    info = cuda_build.BUILD_INFO.get("traverse_wide.cu")
    build_s = info["seconds"] if info else 0.0
    log(f"[2 build] traverse_wide.cu: " + (
        f"nvcc {build_s:.2f} s" if info else
        f"already built in {cuda_build.BUILD}") +
        f" (load {time.perf_counter() - t0:.2f} s)")
    if info:
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log("   ptxas:", line.strip())
    sah.load_native()
    log("[2 build] native SAH builder csrc/libminiro.so loaded")
    return build_s


def phase_kernel_vs_twin(device):
    import torch
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.models.geometry import pack_triangles
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    from cse168_raytracer_tpu_torch.ops.wide_bvh import build_bvh4_sah
    from cse168_raytracer_tpu_torch.scenes import build
    from cse168_raytracer_tpu_torch.scenes.registry import _make_sponza_proxy
    from cse168_raytracer_tpu_torch.models.materials import MaterialBuilder
    from cse168_raytracer_tpu_torch.models.lights import LIGHT_POINT
    from cse168_raytracer_tpu_torch.models.scene import make_scene
    errs = {"closest": 0.0, "any": 0.0}
    rng = np.random.default_rng(SEED)
    log("[3 kernel vs twin]")
    for n_tri in (1, 33, 80, 3000):
        pack = pack_triangles([(random_mesh(n_tri, rng), 0)], device=device)
        o = torch.tensor([[0.0, 0.0, -5.0]], device=device).repeat(4096, 1)
        d = torch.as_tensor(rng.normal(0, 1, (4096, 3)).astype(np.float32),
                            device=device)
        d = (d / d.norm(dim=1, keepdim=True)).contiguous()
        for width in (4, 8):
            bvh = build_bvh4_sah(pack, width=width)[1]
            compare_traversal(f"mesh{n_tri}", bvh, o, d, 0.0, 1e10, errs)

    cfg = RenderConfig(width=RES, height=RES, trace_depth=DEPTH)
    scene, _, cam, _ = build("sponza_proxy", cfg, device=device)
    scene = attach_accel(scene)
    sel = torch.as_tensor(np.sort(rng.choice(RES * RES, N_SUBSET, False)),
                          device=device)
    o, d = primary_rays(cam, RES, RES, device)
    o, d = o[sel].contiguous(), d[sel].contiguous()
    compare_traversal("sponza_proxy primary", scene.accel, o, d, 0.0, 1e12,
                      errs)
    # toward the light inside the atrium: some shadow rays are occluded,
    # some walk the tree to their end
    so, sd, stmax = shadow_rays(lit_sponza(scene), o, d)
    compare_traversal("sponza_proxy shadow", scene.accel, so, sd, 0.0, stmax,
                      errs)

    mb = MaterialBuilder()
    white = mb.phong()
    big, _ = make_scene(
        tris=pack_triangles([(_make_sponza_proxy(target_tris=400_000),
                              white)], device=device),
        materials=mb.build(device),
        lights=[dict(kind=LIGHT_POINT, position=LIT_LIGHT,
                     wattage=200.0)], device=device)
    big = attach_accel(big)
    if big.accel.width != 8:
        raise AssertionError("the 400k-triangle scene did not get W=8")
    compare_traversal(f"sponza_proxy 400k ({big.tris.n_valid} tris)",
                      big.accel, o, d, 0.0, 1e12, errs)
    so, sd, stmax = shadow_rays(big, o, d)
    compare_traversal("sponza_proxy 400k shadow", big.accel, so, sd, 0.0,
                      stmax, errs)
    return errs


def lit_sponza(scene):
    """sponza_proxy with its one point light moved from (0, 10, 0), above
    the atrium's closed ceiling at y = 9, to (0, 8, 0) below the ceiling
    beams. As registered (and in the JAX package) every shadow ray is
    occluded and the image is black; lit, the image and its kd gradient
    carry information that a check can hold."""
    from cse168_raytracer_tpu_torch.models.lights import (LIGHT_POINT,
                                                          make_light_table)
    return scene.replace(lights=make_light_table(
        [dict(kind=LIGHT_POINT, position=LIT_LIGHT, color=(1, 1, 1),
              wattage=200.0)], scene.device))


def timed_steps(scene, static, cam, cfg, n_iter):
    """One warm-up and n_iter timed fwd+bwd steps. Returns the last
    step's (hdr, grad, stats) and the mean ms per step by CUDA events
    and by the host clock."""
    import torch
    fwd_bwd(scene, static, cam, cfg)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n_iter):
        hdr, grad, stats = fwd_bwd(scene, static, cam, cfg)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1000 / n_iter
    return hdr, grad, stats, start.elapsed_time(end) / n_iter, host_ms


def phase_main_path(device):
    import torch
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.ops import wide_bvh
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    from cse168_raytracer_tpu_torch.scenes import build
    cfg = RenderConfig(width=RES, height=RES, trace_depth=DEPTH)
    scene, static, cam, cfg = build("sponza_proxy", cfg, device=device)
    t0 = time.perf_counter()
    scene = attach_accel(scene)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"[4 main path] sponza_proxy {scene.tris.n_valid} tris, "
        f"W={scene.accel.width}, {scene.accel.n_nodes} nodes, "
        f"{scene.accel.n_leaves} leaves, accel build {build_s:.3f} s")

    n_iter = 5
    out = {"scene": scene, "cam": cam, "build_s": build_s}
    for k in wide_bvh.LAUNCHES:
        wide_bvh.LAUNCHES[k] = 0
    for label, s in (("registered", scene), ("lit", lit_sponza(scene))):
        torch.cuda.reset_peak_memory_stats(device)
        hdr, grad, stats, ms, host_ms = timed_steps(s, static, cam, cfg,
                                                    n_iter)
        peak = torch.cuda.max_memory_allocated(device)
        if not (torch.isfinite(hdr).all() and torch.isfinite(grad).all()):
            raise AssertionError(f"main path ({label}): non-finite image "
                                 "or gradient")
        if hdr.shape != (RES, RES, 3) or grad.shape != s.materials.kd.shape:
            raise AssertionError(f"main path ({label}): wrong shapes")
        if label == "lit":
            if not bool(hdr.max() > hdr.min()):
                raise AssertionError("main path (lit): constant image")
            if not bool(grad.abs().sum() > 0):
                raise AssertionError("main path (lit): zero kd gradient")
        rays = int(stats.primary_rays) + int(stats.shadow_rays) \
            + int(stats.secondary_rays)
        log(f"[4 main path] {label}: {1 + n_iter} fwd+bwd steps; per step "
            f"{ms:.3f} ms (CUDA events), {host_ms:.3f} ms (host clock); "
            f"{rays} rays = {int(stats.primary_rays)} primary + "
            f"{int(stats.shadow_rays)} shadow + "
            f"{int(stats.secondary_rays)} secondary; "
            f"{rays / (ms / 1000):.1f} rays/s; peak memory "
            f"{peak / 2**20:.1f} MiB; image mean {float(hdr.mean()):.6g} "
            f"max {float(hdr.max()):.6g}; "
            f"|grad| sum {float(grad.abs().sum()):.6g}")
        out[label] = {"ms": ms, "host_ms": host_ms, "rays": rays,
                      "peak_mib": peak / 2**20}
    out["launches"] = dict(wide_bvh.LAUNCHES)
    log(f"[4 main path] kernel launches over both runs: {out['launches']}")
    for k in ("closest", "any"):
        if out["launches"][k] < 1:
            raise AssertionError(f"main path launched no {k} kernel")
    return out


def phase_card_vs_cpu(device):
    import torch
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    from cse168_raytracer_tpu_torch.scenes import build
    for name in ("sphere", "mixed"):
        out = []
        for dev in (device, torch.device("cpu")):
            cfg = RenderConfig(width=64, height=64, trace_depth=DEPTH)
            if name == "mixed":
                scene, static, cam = mixed_scene(dev)
            else:
                scene, static, cam, _ = build(name, cfg, device=dev)
            scene = attach_accel(scene)
            hdr, grad, stats = fwd_bwd(scene, static, cam, cfg)
            out.append((hdr.cpu(), grad.cpu(), int(stats.secondary_rays)))
        (card_hdr, card_g, card_sec), (cpu_hdr, cpu_g, cpu_sec) = out
        share = pixel_agreement(card_hdr, cpu_hdr)
        g_err = float((card_g - cpu_g).abs().max()
                      / cpu_g.abs().max().clamp(min=1e-30))
        log(f"[5 card vs cpu] {name} 64x64: {share * 100:.3f}% of pixels "
            f"within rtol 1e-4/atol 1e-5; kd-gradient max rel diff "
            f"{g_err:.3g}; secondary rays {card_sec} (card) {cpu_sec} (cpu)")
        if share < 0.999:
            bad = (~torch.isclose(card_hdr, cpu_hdr, **TOL).all(-1)).nonzero()
            for y, x in bad[:8].tolist():
                log(f"   pixel ({y}, {x}): card {card_hdr[y, x].tolist()} "
                    f"cpu {cpu_hdr[y, x].tolist()}")
            raise AssertionError(f"{name}: card and CPU renders disagree")


def phase_plain_timing(device, main, errs):
    import torch
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    scene, cam = main["scene"], main["cam"]
    bvh = scene.accel
    o, d = primary_rays(cam, RES, RES, device)
    so, sd, stmax = shadow_rays(scene, o, d)
    saved = dict(wb.LAUNCHES)
    out = {}
    for mode, args, kern, plain in (
            ("closest", (o, d, 0.0, 1e12), wb.closest_hit_triangles,
             wb.closest_hit_triangles_plain),
            ("any", (so, sd, 0.0, stmax), wb.any_hit_triangles,
             wb.any_hit_triangles_plain)):
        n = args[0].shape[0]
        ms = time_cuda(lambda: kern(bvh, *args), 10)
        sub = tuple(a[:PLAIN_SUBSET] if torch.is_tensor(a) else a
                    for a in args)
        sub_ms = time_cuda(lambda: plain(bvh, *sub), 1)
        est_s = sub_ms / 1000 * n / PLAIN_SUBSET
        if est_s <= PLAIN_BUDGET_S:
            plain_ms, plain_n = time_cuda(lambda: plain(bvh, *args), 1,
                                         warm=False), n
        else:
            plain_ms, plain_n = sub_ms, PLAIN_SUBSET
        # the kernel against the twin at the main path's shapes (or the
        # twin's subset of them)
        compare_traversal(f"main-path {mode} rays", bvh,
                          *(a[:plain_n] if torch.is_tensor(a) else a
                            for a in args), errs)
        log(f"[6 plain timing] {mode}: kernel {ms:.3f} ms for {n} rays; "
            f"plain twin {plain_ms:.1f} ms for {plain_n} rays"
            + ("" if plain_n == n else
               f" (the full {n} would take ~{est_s:.0f} s, over the "
               f"{PLAIN_BUDGET_S:.0f} s budget, so the twin ran on "
               f"{PLAIN_SUBSET} rays)"))
        out[mode] = {"ms": ms, "rays": n, "plain_ms": plain_ms,
                     "plain_rays": plain_n}
    wb.LAUNCHES.update(saved)
    return out


def main():
    device, card = phase_device()
    build_s = phase_build()
    errs = phase_kernel_vs_twin(device)
    main_run = phase_main_path(device)
    phase_card_vs_cpu(device)
    timing = phase_plain_timing(device, main_run, errs)
    import torch
    src = "cse168_raytracer_tpu_torch/csrc/traverse_wide.cu"
    replaces = "cse168_raytracer_tpu/ops/pallas_bvh.py:1056"
    kernels = [
        {"name": "traverse_wide closest+attr (W=4 and W=8)", "route": "cuda",
         "source": src, "replaces": replaces,
         "launches": main_run["launches"]["closest"],
         "max_abs_err": errs["closest"], **timing["closest"]},
        {"name": "traverse_wide any-hit (W=4 and W=8)", "route": "cuda",
         "source": src, "replaces": replaces,
         "launches": main_run["launches"]["any"],
         "max_abs_err": errs["any"], **timing["any"]},
    ]
    log(f"[summary] main path "
        f"{main_run['registered']['ms']:.3f} ms/step as registered, "
        f"{main_run['lit']['ms']:.3f} ms/step lit; card {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
