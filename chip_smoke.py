#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, one
nvcc each, all started together, and prints each kernel's registers,
shared memory and spills (phase 2); holds the wide-tree kernel (the
card walk) against a brute-force oracle on the card, with a ray count
that is not a multiple of 32, dead rays inside warps and a mesh of tied
triangles among the cases (phase 3); drives the
port's main path (sponza_proxy at 512x512, trace depth 4, forward and
backward of sum(render_hdr) with respect to the material table kd, as
bench.py does for the JAX package; once as registered and once with its
light moved inside the atrium, see lit_sponza) (phase 4); checks the
card's renders against the CPU's, Whitted and path-traced, and the
path-traced children on the card's own generator (phase 5); holds the
kernel, with and without its counters (K3), against its plain PyTorch
version walk_plain and the per-ray kernel it replaced on every ray of
the main path, and times all three, the two kernels in turns (phase 6),
and holds it against walk_plain on phase 3's rays (phase 7); drives the
command line's `render` on the card at 512x512 with --stats, Whitted
and path-traced through the thin lens at 16 spp, each as registered and
lit (phase 8); and runs
the A/B accelerator kinds on lit sponza_proxy (phase 9): (a) the fwd+bwd
step with "pallas_sah" (the binary tree, kernel K5) and "pallas" (the
Morton-block brute force, K6) against the "auto" step, (b) K5 in its
three modes and K6 against their plain versions on the main path's
primary and shadow rays, timed with their bounds, and against the brute
force, (c) a collect_stats render through K5 and traversal_stats, (d) a
forward render with each of "block", "bvh", "packet" and
"pallas_forest" against auto's, and (e) the W=8 kernel (K4) on the
400k-triangle proxy, timed with its bound and beside the per-ray kernel.
Each phase prints its own lines; any failure raises and exits non-zero.
The second-to-last line is a JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}. Without a CUDA device it
fails at once.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
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
SPP = 16

# the least time of a traversal (H100 SXM peak rates at its 700 W
# power limit): the larger of its bytes over the memory
# rate and its f32 operations, counted from traverse_wide.cu, over the
# rate outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
OPS_PER_SLOT = 37    # per axis 8 add/sub/mul and 4 min/max; 1 compare
OPS_PER_TRI = 53     # 44 mul/add/div (3 x 11 + 6 + 1 + 3 + 1), 9 cmp/select
OPS_PER_RAY = 12     # 3 reciprocals and the 9 operations of the moment
OPS_PER_BOX = 25     # tri_blocks.cu's slab: per axis 4 sub/mul, 4 min/max
KINDS_RES = 512      # phase 9(d)'s renders
FOREST_CHUNK = 65_536


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


def tie_mesh(n_base, rng):
    """n_base triangles on a 1/16 grid, each twice as it is and twice
    scaled by 2 about its first vertex. Every hit ties: the copies have
    equal operands and fall on two lanes of one leaf, and the scaled
    triangle has the same t exactly (its operands scale by powers of
    two) but another centroid, which the builder may put in another
    leaf."""
    v0 = rng.integers(-32, 33, (n_base, 3)) / 16
    e1 = rng.integers(-4, 5, (n_base, 3)) / 16
    e2 = rng.integers(-4, 5, (n_base, 3)) / 16
    tri = np.stack([v0, v0 + e1, v0 + e2], 1)
    big = np.stack([v0, v0 + 2 * e1, v0 + 2 * e2], 1)
    v = np.concatenate([tri, big, tri, big]).reshape(-1, 3)
    n = v.shape[0] // 3
    f = np.arange(3 * n, dtype=np.int64).reshape(n, 3)
    return {"vertices": v.astype(np.float32),
            "normals": np.tile(np.float32([[0, 0, 1]]), (3 * n, 1)),
            "texcoords": np.zeros((0, 2), np.float32), "tri_vidx": f,
            "tri_nidx": f, "tri_tidx": np.full((n, 3), -1, np.int64)}


def tie_counts(bvh, o, d, t):
    """Of the rays that hit (t < BIG), how many have a second triangle
    at their t in the winning leaf, and how many in another leaf."""
    import torch
    from cse168_raytracer_tpu_torch.core.vecmath import cross
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    hr = torch.nonzero(t < 3e37)[:, 0]
    o, d, th = o[hr], d[hr], t[hr]
    m = cross(o, d)
    col = lambda x: x[:, None, None]
    tm = wb._lane_t(bvh.leafW[None], [col(x) for x in (*d.T, *m.T)],
                    [col(x) for x in o.T], col(torch.zeros_like(th)),
                    col(torch.full_like(th, 1e10)))        # (R, L, K)
    per_leaf = (tm == th[:, None, None]).sum(2)
    return (int((per_leaf >= 2).any(1).sum()),
            int(((per_leaf > 0).sum(1) >= 2).sum()))


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

def compare_oracle(label, bvh, o, d, tmin, tmax):
    """Kernel against the brute-force oracle on the card, closest+attr
    and any-hit, at the bar of tests/test_bvh.py::_check_against_brute
    plus bit-equal attribute rows where the ids agree and equal any-hit
    masks."""
    import torch
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    t, ids, attr = wb.closest_hit_triangles(bvh, o, d, tmin, tmax)
    tp, idp, attrp = wb.brute_force_triangles(bvh, o, d, tmin, tmax)
    occ = wb.any_hit_triangles(bvh, o, d, tmin, tmax) < 3e37
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
    if not torch.equal(occ, hitp):
        raise AssertionError(f"{label}: any-hit masks differ")
    err = float((t[both] - tp[both]).abs().max()) if both.any() else 0.0
    log(f"  {label}: W={bvh.width} rays={o.shape[0]} hits={int(hit.sum())} "
        f"occluded={int(occ.sum())} max|dt|={err:.3g} id_agree={agree:.5f} "
        f"bit_equal_t={bool(torch.equal(t[both], tp[both]))}")


def compare_plain(label, bvh, args, errs, wb=None):
    """The kernel without and with its counters (K3; K5's with a binary
    tree and wb = ops.binary_bvh) against its plain version (walk_plain,
    walk_binary_plain) on the same rays, in both modes: t, id,
    attributes and visit counts all equal. Folds the differences (zero
    unless it raises) into errs and returns each mode's (internal, leaf)
    visits summed over the rays."""
    import torch
    if wb is None:
        from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    width = getattr(bvh, "width", 2)
    visits = {}
    for any_hit in (False, True):
        mode = "any" if any_hit else "closest"
        kern = wb.any_hit_triangles if any_hit else wb.closest_hit_triangles
        plain = (wb.any_hit_triangles_plain if any_hit
                 else wb.closest_hit_triangles_plain)
        got = kern(bvh, *args)
        got = got if isinstance(got, tuple) else (got,)
        *counted, box, tri = kern(bvh, *args, with_stats=True)
        *ref, p_box, p_tri = plain(bvh, *args, with_stats=True)
        torch.cuda.synchronize()
        for name, a, b, c in zip(("t", "id", "attributes"), got, counted,
                                 ref):
            if not torch.equal(a, c):
                raise AssertionError(f"{label} {mode}: the kernel's {name} "
                                     "differ from walk_plain's")
            if not torch.equal(b, c):
                raise AssertionError(f"{label} {mode}: counting changed "
                                     f"the kernel's {name}")
        hit = ref[0] < 3e37
        d_t = float((got[0] - ref[0])[hit].abs().max()) if hit.any() else 0.0
        d_box = int((box - p_box).abs().max())
        d_tri = int((tri - p_tri).abs().max())
        if d_box or d_tri:
            raise AssertionError(f"{label} {mode}: the kernel's counts "
                                 "differ from the plain walk's (box "
                                 f"{d_box}, tri {d_tri})")
        errs[mode] = max(errs[mode], d_t)
        errs["stats"] = max(errs["stats"], d_t, d_box, d_tri)
        visits[mode] = (int(p_box.sum(dtype=torch.int64)) // width,
                        int(p_tri.sum(dtype=torch.int64)) // wb.K)
        n = args[0].shape[0]
        log(f"  {label} {mode}: W={width} {n} rays, hits "
            f"{int(hit.sum())}; kernel = plain walk in t, id, attributes "
            f"and counts, with and without counting; per ray "
            f"{float(box.double().mean()):.3f} box and "
            f"{float(tri.double().mean()):.3f} triangle tests")
    return visits


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


def time_turns(new, old, reps, label):
    """Mean milliseconds of new() and of old() by time_cuda, timed in
    turns old, new, new, old so that drift in the card's clock or its
    neighbours' load falls on both."""
    o1, n1, n2, o2 = (time_cuda(f, reps) for f in (old, new, new, old))
    log(f"  {label}: in turns per-ray {o1:.3f}, card walk {n1:.3f}, card "
        f"walk {n2:.3f}, per-ray {o2:.3f} ms")
    return (n1 + n2) / 2, (o1 + o2) / 2


def compare_per_ray(label, bvh, args):
    """The per-ray kernel (the design the card walk replaced) against the
    card walk on the same rays, in both modes, with and without
    counters: every output equal."""
    import torch
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    o, d = args[:2]
    bounds = wb._bounds(o, *args[2:])
    for any_hit in (False, True):
        for stats in (False, True):
            new = wb._launch(bvh, o, d, *bounds, any_hit, stats)
            old = wb._launch_per_ray(bvh, o, d, *bounds, any_hit, stats)
            for a, b in zip(new, old):
                if a is not None and not torch.equal(a, b):
                    raise AssertionError(f"{label}: the per-ray kernel and "
                                         "the card walk differ")
    log(f"  {label}: per-ray kernel = card walk in every output, both "
        "modes, with and without counters")


def fwd_bwd(scene, static, cam, cfg, gen=None):
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    kd = scene.materials.kd.detach().clone().requires_grad_(True)
    s = scene.replace(materials=scene.materials.replace(kd=kd))
    hdr, stats = render_hdr(s, static, cam, cfg, gen)
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
    """Phase 2: every kernel source built at once, one nvcc each, and
    loaded; the native SAH builder."""
    from cse168_raytracer_tpu_torch.ops import (binary_bvh, cuda_build, sah,
                                                tri_blocks, wide_bvh)
    t0 = time.perf_counter()
    cuda_build.build_all()
    for mod in (wide_bvh, binary_bvh, tri_blocks):
        mod._kernel_lib()
    build_s = time.perf_counter() - t0
    log(f"[2 build] {len(cuda_build.SOURCES)} kernel sources built and "
        f"loaded in {build_s:.2f} s")
    ptxas = {}
    for src in cuda_build.SOURCES:
        info = cuda_build.BUILD_INFO[src]
        log(f"[2 build] {src}: " + (f"nvcc {info['seconds']:.2f} s"
                                    if info["seconds"] is not None else
                                    f"already built, {info['path']}"))
        for name, k in ptxas_kernels(info["log"]).items():
            ptxas[name] = k
            log(f"   ptxas: {name}: {k['registers']} registers, "
                f"{k['smem']} bytes static shared memory, spill stores "
                f"{k['spill_stores']} bytes, loads {k['spill_loads']} bytes")
    # the card walk's eight instantiations, each reported and spilling
    # nothing: spills would put its leaf operands in local memory
    for w in (4, 8):
        for mode in ("closest", "any"):
            for stats in ("", " stats"):
                name = f"traverse_warp W={w} {mode}{stats}"
                k = ptxas.get(name)
                if k is None:
                    raise RuntimeError(f"phase 2: nvcc's report has no {name}")
                if k["spill_stores"] or k["spill_loads"]:
                    raise RuntimeError(f"phase 2: {name} spills "
                                       f"{k['spill_stores']} bytes of stores "
                                       f"and {k['spill_loads']} of loads")
    sah.load_native()
    log(f"[2 build] native SAH builder {sah.native_library_path()} loaded")
    return build_s, ptxas


def ptxas_kernels(text):
    """{kernel: {"registers", "smem", "spill_stores", "spill_loads"}}
    from nvcc's -Xptxas -v report; traverse_wide.cu's kernels named as
    "traverse_warp W=4 closest" or "traverse_per_ray W=8 any stats"."""
    import re
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", line)
        if m:
            cur = m.group(1)
            t = re.search(r"(traverse_warp|traverse_per_ray)ILi(\d)ELb"
                          r"([01])ELb([01])E", cur)
            if t:
                cur = (f"{t.group(1)} W={t.group(2)} "
                       f"{'any' if t.group(3) == '1' else 'closest'}"
                       + (" stats" if t.group(4) == "1" else ""))
            out.setdefault(cur, {"registers": 0, "smem": 0,
                                 "spill_stores": 0, "spill_loads": 0})
            continue
        if cur is None:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("smem", r"(\d+) bytes smem"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads")):
            m = re.search(pat, line)
            if m:
                out[cur][key] = int(m.group(1))
    return out


def phase_kernel_vs_oracle(device):
    """Phase 3: the kernel against the brute-force oracle on random
    meshes and on 8,192 of the main path's primary and shadow rays, on
    sponza_proxy's W=4 tree and a 400k-triangle W=8 one, and on both
    trees with a ragged ray count and with dead rays inside warps; a tie
    mesh on both widths (t against the brute force). Returns the (label,
    tree, rays) cases for phase 7 and the sponza_proxy rays for phase
    9."""
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
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    cases = []
    rng = np.random.default_rng(SEED)
    log("[3 kernel vs oracle]")
    for n_tri in (1, 33, 80, 3000):
        pack = pack_triangles([(random_mesh(n_tri, rng), 0)], device=device)
        o = torch.tensor([[0.0, 0.0, -5.0]], device=device).repeat(4096, 1)
        d = torch.as_tensor(rng.normal(0, 1, (4096, 3)).astype(np.float32),
                            device=device)
        d = (d / d.norm(dim=1, keepdim=True)).contiguous()
        for width in (4, 8):
            bvh = build_bvh4_sah(pack, width=width)[1]
            compare_oracle(f"mesh{n_tri}", bvh, o, d, 0.0, 1e10)
            cases.append((f"mesh{n_tri}", bvh, (o, d, 0.0, 1e10)))

    cfg = RenderConfig(width=RES, height=RES, trace_depth=DEPTH)
    scene, _, cam, _ = build("sponza_proxy", cfg, device=device)
    scene = attach_accel(scene)
    sel = torch.as_tensor(np.sort(rng.choice(RES * RES, N_SUBSET, False)),
                          device=device)
    o, d = primary_rays(cam, RES, RES, device)
    o, d = o[sel].contiguous(), d[sel].contiguous()
    compare_oracle("sponza_proxy primary", scene.accel, o, d, 0.0, 1e12)
    # toward the light inside the atrium: some shadow rays are occluded,
    # some walk the tree to their end
    so, sd, stmax = shadow_rays(lit_sponza(scene), o, d)
    compare_oracle("sponza_proxy shadow", scene.accel, so, sd, 0.0, stmax)
    cases += [("sponza_proxy primary", scene.accel, (o, d, 0.0, 1e12)),
              ("sponza_proxy shadow", scene.accel, (so, sd, 0.0, stmax))]
    sponza_rays = {"primary": (o, d, 0.0, 1e12),
                   "shadow": (so, sd, 0.0, stmax)}

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
    compare_oracle(f"sponza_proxy 400k ({big.tris.n_valid} tris)",
                   big.accel, o, d, 0.0, 1e12)
    so, sd, stmax = shadow_rays(big, o, d)
    compare_oracle("sponza_proxy 400k shadow", big.accel, so, sd, 0.0, stmax)
    cases += [("sponza_proxy 400k primary", big.accel, (o, d, 0.0, 1e12)),
              ("sponza_proxy 400k shadow", big.accel, (so, sd, 0.0, stmax))]

    # the card walk's edge cases, each on both widths: a ray count that
    # leaves the last warp 31 rays, and dead rays (tmax < tmin) inside
    # every warp; phase 7 holds them, and the ties, against walk_plain
    m = N_SUBSET - 1
    dead = torch.where(torch.arange(N_SUBSET, device=device) % 5 == 2,
                       -1.0, 1e12)
    for label, tree in (("sponza_proxy", scene.accel),
                        ("sponza_proxy 400k", big.accel)):
        args = {f"{label} ragged, {m} rays": (o[:m], d[:m], 0.0, 1e12),
                f"{label} dead every 5th": (o, d, 0.0, dead)}
        for key, a in args.items():
            compare_oracle(key, tree, *a)
            cases.append((key, tree, a))
    pack = pack_triangles([(tie_mesh(1000, rng), 0)], device=device)
    n_tie = N_SUBSET // 2
    td = torch.as_tensor(rng.normal(0, 1, (n_tie, 3)).astype(np.float32),
                         device=device)
    td[:, 2] = td[:, 2].abs()
    td = (td / td.norm(dim=1, keepdim=True)).contiguous()
    to = torch.tensor([[0.0, 0.0, -5.0]], device=device).repeat(n_tie, 1)
    for width in (4, 8):
        bvh = build_bvh4_sah(pack, width=width)[1]
        t = wb.closest_hit_triangles(bvh, to, td, 0.0, 1e10)[0]
        tp = wb.brute_force_triangles(bvh, to, td, 0.0, 1e10)[0]
        in_leaf, across = tie_counts(bvh, to, td, tp)
        log(f"  ties: W={width} rays={n_tie} hits={int((tp < 3e37).sum())}; "
            f"{in_leaf} of them tie in the winning leaf, {across} across "
            f"leaves; t equal to the brute force's: {torch.equal(t, tp)}")
        if not torch.equal(t, tp) or not in_leaf or not across:
            raise AssertionError(f"ties W={width}: t differs from the brute "
                                 "force's, or the mesh makes no ties")
        cases.append((f"ties ({pack.n_valid} tris)", bvh,
                      (to, td, 0.0, 1e10)))
    return cases, sponza_rays


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
        f"{scene.accel.n_leaves} leaves, accel build {build_s:.3f} s; "
        f"{stack_line(scene.accel)}")

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


def stack_line(bvh):
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    nbytes = wb._stack_smem_bytes(wb._kernel_lib(), bvh.stack_depth)
    return (f"the card walk's stacks: {bvh.stack_depth} slots a thread, "
            f"{nbytes} bytes of dynamic shared memory a block")


def phase_card_vs_cpu(device):
    """Phase 5: renders at 64x64 on the card and on the CPU, Whitted and
    path-traced (mixed_scene's glossy mirror and glass spheres spawn
    lobe-sampled children). The path-traced pair draws from one seeded
    CPU generator, so both consume the same uniforms; its traversal
    counters (K3 on the card, walk_plain on the CPU) must agree too."""
    import torch
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    from cse168_raytracer_tpu_torch.scenes import build
    pt = dict(path_tracing=True, trace_samples=2, collect_stats=True)
    for name, extra in (("sphere", {}), ("mixed", {}),
                        ("mixed path-traced", pt)):
        out = []
        for dev in (device, torch.device("cpu")):
            cfg = RenderConfig(width=64, height=64, trace_depth=DEPTH, **extra)
            if name.startswith("mixed"):
                scene, static, cam = mixed_scene(dev)
            else:
                scene, static, cam, _ = build(name, cfg, device=dev)
            scene = attach_accel(scene)
            gen = torch.Generator("cpu").manual_seed(SEED) if extra else None
            hdr, grad, stats = fwd_bwd(scene, static, cam, cfg, gen)
            out.append((hdr.cpu(), grad.cpu(),
                        {f: int(getattr(stats, f)) for f in (
                            "secondary_rays", "shadow_rays", "box_tests",
                            "tri_tests")}))
        (card_hdr, card_g, card_st), (cpu_hdr, cpu_g, cpu_st) = out
        share = pixel_agreement(card_hdr, cpu_hdr)
        g_err = float((card_g - cpu_g).abs().max()
                      / cpu_g.abs().max().clamp(min=1e-30))
        log(f"[5 card vs cpu] {name} 64x64: {share * 100:.3f}% of pixels "
            f"within rtol 1e-4/atol 1e-5; kd-gradient max rel diff "
            f"{g_err:.3g}; card {card_st}, cpu {cpu_st}")
        if share < 0.999:
            bad = (~torch.isclose(card_hdr, cpu_hdr, **TOL).all(-1)).nonzero()
            for y, x in bad[:8].tolist():
                log(f"   pixel ({y}, {x}): card {card_hdr[y, x].tolist()} "
                    f"cpu {cpu_hdr[y, x].tolist()}")
            raise AssertionError(f"{name}: card and CPU renders disagree")
        if extra:
            if card_st["secondary_rays"] <= 0 or card_st["box_tests"] <= 0:
                raise AssertionError(f"{name}: no children or no counts")
            # the same draws: only a direction rounded differently by the
            # card's transcendentals may change a walk
            for f, v in card_st.items():
                if abs(v - cpu_st[f]) > 1e-3 * max(cpu_st[f], 1):
                    raise AssertionError(f"{name}: {f} {v} on the card, "
                                         f"{cpu_st[f]} on the CPU")


def phase_children_on_card(device):
    """Phase 5: a path-traced render on the card's own generator (the
    render's default), with counters: the glossy children are drawn on
    the card, compacted and traced through K3. At one sample the render
    to depth 0 draws the same primary rays, so the counts the deeper
    render adds are those of the children's traversals."""
    import torch
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    scene, static, cam = mixed_scene(device)
    scene = attach_accel(scene)
    saved = dict(wb.LAUNCHES)
    st = {}
    with torch.no_grad():
        for depth in (0, DEPTH):
            cfg = RenderConfig(width=RES // 4, height=RES // 4,
                               trace_depth=depth, path_tracing=True,
                               trace_samples=1, collect_stats=True)
            wb.LAUNCHES["stats_closest"] = 0
            hdr, stats = render_hdr(scene, static, cam, cfg)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(hdr).all()):
                raise AssertionError("path-traced render: non-finite image")
            st[depth] = (int(stats.secondary_rays), int(stats.box_tests),
                         int(stats.tri_tests), wb.LAUNCHES["stats_closest"])
    wb.LAUNCHES.update(saved)
    (_, box0, tri0, n0), (sec, box, tri, n) = st[0], st[DEPTH]
    log(f"[5 children] mixed {RES // 4}x{RES // 4} path-traced on the "
        f"card's generator: {sec} secondary rays; their traversals "
        f"{box - box0} box and {tri - tri0} triangle tests "
        f"({n - n0} more K3 launches than at depth 0)")
    if sec <= 0 or box <= box0 or tri <= tri0 or n <= n0:
        raise AssertionError("the path-traced children did not go through "
                             "K3 on the card")


def phase_plain_timing(device, main, errs):
    """Phase 6: on every ray of the main path (the registered scene's
    primary rays and its shadow rays, and the lit scene's shadow rays),
    the kernel with and without counters against walk_plain, exactly,
    and against the brute-force oracle on as many rays as its budget
    allows; then each kernel's time beside its plain version's, and the
    bounds from this run's visit counts."""
    import torch
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    scene, cam = main["scene"], main["cam"]
    bvh = scene.accel
    saved = dict(wb.LAUNCHES)
    o, d = primary_rays(cam, RES, RES, device)
    so, sd, stmax = shadow_rays(scene, o, d)
    lo, ld, ltmax = shadow_rays(lit_sponza(scene), o, d)
    rays = {"primary": (o, d, 0.0, 1e12), "shadow": (so, sd, 0.0, stmax),
            "lit shadow": (lo, ld, 0.0, ltmax)}
    visits = {k: compare_plain(f"main-path {k} rays", bvh, args, errs)
              for k, args in rays.items()}
    out, work = {}, {}
    for mode, key in (("closest", "primary"), ("any", "shadow")):
        args = rays[key]
        any_hit = mode == "any"
        kern = wb.any_hit_triangles if any_hit else wb.closest_hit_triangles
        plain = (wb.any_hit_triangles_plain if any_hit
                 else wb.closest_hit_triangles_plain)
        n = args[0].shape[0]
        compare_per_ray(f"main-path {key} rays", bvh, args)
        per_ray = lambda stats: wb._launch_per_ray(bvh, *args, any_hit, stats)
        ms, per_ray_ms = time_turns(lambda: kern(bvh, *args),
                                    lambda: per_ray(False), 10, mode)
        stats_ms, stats_per_ray_ms = time_turns(
            lambda: kern(bvh, *args, with_stats=True), lambda: per_ray(True),
            10, mode + " with counters")
        plain_ms = time_cuda(lambda: plain(bvh, *args), 2)
        stats_plain_ms = time_cuda(lambda: plain(bvh, *args,
                                                 with_stats=True), 2)
        # the brute-force oracle on all the rays, or on a subset when the
        # whole would overrun its budget
        sub = tuple(a[:PLAIN_SUBSET] if torch.is_tensor(a) else a
                    for a in args)
        sub_ms = time_cuda(lambda: wb.brute_force_triangles(bvh, *sub), 1)
        est_s = sub_ms / 1000 * n / PLAIN_SUBSET
        oracle_n = n if est_s <= PLAIN_BUDGET_S else PLAIN_SUBSET
        compare_oracle(f"main-path {key} rays", bvh,
                       *(a[:oracle_n] if torch.is_tensor(a) else a
                         for a in args))
        internal, leaves = visits[key][mode]
        for counting in (False, True):
            work[(mode, counting)] = traversal_work(bvh, n, any_hit, counting,
                                                    internal, leaves)
        out[mode] = {"ms": ms, "per_ray_ms": per_ray_ms, "rays": n,
                     "plain_ms": plain_ms, "plain_rays": n,
                     **bound(work[(mode, False)])}
        out["stats_" + mode] = {"ms": stats_ms,
                                "per_ray_ms": stats_per_ray_ms,
                                "plain_ms": stats_plain_ms}
        log(f"[6 plain timing] {key} rays, {mode}: kernel {ms:.3f} ms, with "
            f"counters {stats_ms:.3f} ms (per-ray kernel {per_ray_ms:.3f} "
            f"and {stats_per_ray_ms:.3f} ms), for {n} rays; walk_plain "
            f"{plain_ms:.1f} ms ({stats_plain_ms:.1f} ms with counts); "
            f"{internal} internal and {leaves} leaf visits "
            f"({internal / n:.3f} and {leaves / n:.3f} per ray); oracle on "
            f"{oracle_n} rays"
            + ("" if oracle_n == n else
               f" (all {n} would take ~{est_s:.0f} s, over its "
               f"{PLAIN_BUDGET_S:.0f} s budget)"))
        log(f"[6 bound] {mode}: {bound_line(work[(mode, False)])}; kernel "
            f"{ms:.3f} ms = {out[mode]['bound_ms'] / ms * 100:.2f}% of bound"
            f" (per-ray kernel "
            f"{out[mode]['bound_ms'] / per_ray_ms * 100:.2f}%)")
    both = [work[(m, True)] for m in ("closest", "any")]
    total = {k: sum(w[k] for w in both) for k in both[0]}
    out["stats"] = {
        **{k: out["stats_closest"][k] + out["stats_any"][k]
           for k in ("ms", "per_ray_ms", "plain_ms")},
        "rays": 2 * RES * RES, "plain_rays": 2 * RES * RES, **bound(total)}
    log(f"[6 bound] counting, both modes: {bound_line(total)}; kernels "
        f"{out['stats']['ms']:.3f} ms (per-ray kernels "
        f"{out['stats']['per_ray_ms']:.3f} ms)")
    wb.LAUNCHES.update(saved)
    return out


def traversal_work(bvh, n, any_hit, counting, internal, leaves):
    """Bytes and f32 operations of one traversal of n rays that makes
    `internal` and `leaves` visits: each ray's o, d, tmin, tmax read and
    its outputs written once, the tree read once; W slab tests per
    internal visit and K triangle tests per leaf visit."""
    from cse168_raytracer_tpu_torch.ops.wide_bvh import K
    tree = [bvh.cbox, bvh.links, bvh.leafW] + ([] if any_hit
                                               else [bvh.attrA])
    out_b = 4 if any_hit else 4 + 4 + 32 * 4      # t; t, id, attributes
    out_b += 8 if counting else 0                 # two visit counts
    nbytes = n * (32 + out_b) + sum(x.numel() * x.element_size()
                                    for x in tree)
    ops = (n * OPS_PER_RAY + internal * bvh.width * OPS_PER_SLOT
           + leaves * K * OPS_PER_TRI)
    return {"bytes": nbytes, "ops": ops}


def bound(w):
    """{"bound_ms", "bound_by"} of a traversal's work."""
    t_bytes = w["bytes"] / HBM_BYTES_S * 1e3
    t_ops = w["ops"] / F32_OPS_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bound_line(w):
    return (f"{w['bytes'] / 1e6:.3f} MB ({w['bytes'] / HBM_BYTES_S * 1e3:.4f}"
            f" ms at 3.35 TB/s), {w['ops'] / 1e9:.3f} G f32 ops "
            f"({w['ops'] / F32_OPS_S * 1e3:.4f} ms at 67 TFLOP/s): bound "
            f"{bound(w)['bound_ms']:.4f} ms by {bound(w)['bound_by']}")


def phase_k3(cases, errs):
    """Phase 7: kernel K3 against the plain walk on the card, on phase
    3's meshes and its 8,192 primary and shadow rays of the W=4 and W=8
    trees, in both modes: equal visit counts, and t, id and attributes
    as walk_plain and the kernel without counters give them."""
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    saved = dict(wb.LAUNCHES)
    log("[7 K3]")
    for label, bvh, args in cases:
        compare_plain(label, bvh, args, errs)
    wb.LAUNCHES.update(saved)


def phase_cli(device, card):
    """Phase 8: the command line's render on the card at 512x512, depth
    4, with --stats: (a) Whitted and (b) path-traced through the thin
    lens at SPP samples, each on sponza_proxy as registered and lit (the
    same scene, built here with its light moved and handed to the render
    command). Its [scene] ... [out] lines go to this script's output."""
    import torch
    from cse168_raytracer_tpu_torch import cli
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    from cse168_raytracer_tpu_torch.scenes import build
    scene, static, cam, _ = build("sponza_proxy", device=device)
    lit = (lit_sponza(scene), static, cam)
    del scene
    runs = {}
    for k in wb.LAUNCHES:
        wb.LAUNCHES[k] = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name, built in (("sponza_proxy", None), ("sponza_proxy lit", lit)):
            for label, extra in (("a", []), ("b", [
                    "--path-tracing", "--dof", "--spp", str(SPP)])):
                out = os.path.join(tmp, f"{name.replace(' ', '_')}_{label}"
                                   ".png")
                argv = ["render", "--scene", "sponza_proxy", "--width",
                        str(RES), "--height", str(RES), "--depth", str(DEPTH),
                        "--stats", "--out", out] + extra
                log("[8 cli] python -m cse168_raytracer_tpu_torch.cli "
                    + " ".join(x for x in argv if x not in ("--out", out))
                    + (f" (light moved to {LIT_LIGHT})" if built else ""))
                with contextlib.redirect_stderr(sys.stdout):
                    res = cli.render(cli.parser().parse_args(argv), built)
                if not os.path.getsize(out):
                    raise AssertionError(f"cli {name} ({label}): no image")
                hdr, st = res["hdr"], res["stats"]
                if hdr.shape != (RES, RES, 3) or not bool(
                        torch.isfinite(hdr).all()):
                    raise AssertionError(f"cli {name} ({label}): image")
                if built and not bool(hdr.max() > hdr.min()):
                    raise AssertionError(f"cli {name} ({label}): constant")
                if int(st.box_tests) <= 0 or int(st.tri_tests) <= 0:
                    raise AssertionError(f"cli {name} ({label}): counters")
                ms = res["steady_s"] * 1e3
                n_rays = res["rays"]
                runs[(name, label)] = r = {
                    "ms": ms, "ms_per_sample": ms / res["samples"],
                    "rays": n_rays, "rays_s": n_rays / res["steady_s"],
                    "box_per_ray": int(st.box_tests) / n_rays,
                    "tri_per_ray": int(st.tri_tests) / n_rays}
                log(f"[8 cli] {name} ({label}): {ms:.3f} ms per render "
                    f"({r['ms_per_sample']:.3f} ms/sample), {n_rays} rays, "
                    f"{r['rays_s']:.1f} rays/s, {r['box_per_ray']:.3f} box "
                    f"and {r['tri_per_ray']:.3f} triangle tests per ray; "
                    f"image mean {float(hdr.mean()):.6g}; card {card}")
    launches = dict(wb.LAUNCHES)
    log(f"[8 cli] kernel launches over the four renders: {launches}")
    for k in ("stats_closest", "stats_any"):
        if launches[k] < 1:
            raise AssertionError(f"the command line launched no {k} kernel")
    return runs, launches


# ---------------------------------------------------------------------------
# phase 9: the A/B accelerator kinds
# ---------------------------------------------------------------------------

def zero_launches(*mods):
    for mod in mods:
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0


def kinds_scene(device):
    """sponza_proxy lit, at the main path's size, without an accelerator."""
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.scenes import build
    cfg = RenderConfig(width=RES, height=RES, trace_depth=DEPTH)
    scene, static, cam, cfg = build("sponza_proxy", cfg, device=device)
    return lit_sponza(scene), static, cam, cfg


def timed_attach(scene, kind, **kw):
    import torch
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    t0 = time.perf_counter()
    s = attach_accel(scene, kind, **kw)
    torch.cuda.synchronize()
    return s, time.perf_counter() - t0


def grad_rel(g, ref):
    return float((g - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


def phase_kind_steps(device, lit, static, cam, cfg):
    """Phase 9(a): the fwd+bwd step with kind "pallas_sah" (kernel K5) and
    "pallas" (K6), each timed over 5 steps after a warm-up, against the
    "auto" step's image and kd gradient. Returns the scenes and numbers."""
    from cse168_raytracer_tpu_torch.ops import binary_bvh, tri_blocks
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    n_iter = 5
    auto, _ = timed_attach(lit, "auto")
    ref_hdr, ref_grad, _ = fwd_bwd(auto, static, cam, cfg)
    out = {"auto": auto}
    for kind, mod in (("pallas_sah", binary_bvh), ("pallas", tri_blocks)):
        s, build_s = timed_attach(lit, kind)
        zero_launches(mod, wb)
        hdr, grad, stats, ms, host_ms = timed_steps(s, static, cam, cfg,
                                                    n_iter)
        launches = dict(mod.LAUNCHES)
        share, g_rel = pixel_agreement(hdr, ref_hdr), grad_rel(grad, ref_grad)
        per_step = {k: v / (1 + n_iter) for k, v in launches.items()}
        log(f"[9a steps] {kind}: accel build {build_s:.3f} s; "
            f"{1 + n_iter} fwd+bwd steps at {RES}x{RES}, depth {DEPTH}, lit; "
            f"per step {ms:.3f} ms (CUDA events), {host_ms:.3f} ms (host "
            f"clock); {share * 100:.3f}% of pixels within rtol 1e-4/atol "
            f"1e-5 of auto's; kd-gradient max rel diff {g_rel:.3g}; "
            f"launches {launches} ({per_step} per step; traverse_wide "
            f"{dict(wb.LAUNCHES)})")
        if not (bool(hdr.isfinite().all()) and bool(grad.isfinite().all())):
            raise AssertionError(f"{kind} step: non-finite image or gradient")
        if share < 0.999 or g_rel > 1e-4:
            raise AssertionError(f"{kind} step disagrees with auto's")
        if sum(launches.values()) < 1 or sum(wb.LAUNCHES.values()):
            raise AssertionError(f"{kind} step did not go through its kernel")
        out[kind] = s
        out[kind + " step"] = {"ms": ms, "host_ms": host_ms,
                               "launches": launches, "build_s": build_s}
    return out


def plain_rays(label, fn, args, n):
    """How many of the n rays the plain version fn(*args) takes within
    PLAIN_BUDGET_S: all, or PLAIN_SUBSET when PLAIN_SUBSET of them,
    timed, say that all would take longer."""
    import torch
    if n <= PLAIN_SUBSET:
        return n
    sub = tuple(a[:PLAIN_SUBSET] if torch.is_tensor(a) else a for a in args)
    est_s = time_cuda(lambda: fn(*sub), 1, warm=False) / 1e3 \
        * n / PLAIN_SUBSET
    if est_s <= PLAIN_BUDGET_S:
        return n
    log(f"  {label}: the plain version on all {n} rays would take ~"
        f"{est_s:.0f} s, over its {PLAIN_BUDGET_S:.0f} s budget: held on "
        f"the first {PLAIN_SUBSET} rays")
    return PLAIN_SUBSET


def head(args, m):
    import torch
    return tuple(a[:m] if torch.is_tensor(a) else a for a in args)


def block_work(blocks, n, pairs):
    """Bytes and f32 operations of one K6 launch over n rays whose tiles
    pass `pairs` (tile, block) box tests: every ray's o, d, tmin, tmax
    read and its t and id written once, the block arrays read once; 256
    slab tests per block per tile, 256 x 256 triangle tests per pair."""
    from cse168_raytracer_tpu_torch.ops.tri_blocks import BLOCK, RAY_TILE
    tiles = -(-n // RAY_TILE)
    nbytes = n * (32 + 8) + sum(x.numel() * x.element_size()
                                for x in (blocks.w6, blocks.w4, blocks.aabb))
    ops = (n * OPS_PER_RAY + tiles * blocks.num_blocks * RAY_TILE
           * OPS_PER_BOX + pairs * RAY_TILE * BLOCK * OPS_PER_TRI)
    return {"bytes": nbytes, "ops": ops}


def binary_work(bvh, n, any_hit, counting, internal, leaves):
    """traversal_work for the binary tree: 2 slab tests per internal
    visit, no attribute rows."""
    from cse168_raytracer_tpu_torch.ops.wide_bvh import K
    out_b = (4 if any_hit else 8) + (8 if counting else 0)
    nbytes = n * (32 + out_b) + sum(x.numel() * x.element_size()
                                    for x in (bvh.cbox, bvh.leafW))
    ops = (n * OPS_PER_RAY + internal * 2 * OPS_PER_SLOT
           + leaves * K * OPS_PER_TRI)
    return {"bytes": nbytes, "ops": ops}


def tri_rows(pack, ids):
    """The triangles that ids name in `pack`, as their vertex rows, so
    that the ids of two orderings of one mesh compare."""
    import torch
    ids = ids.long()
    return torch.cat([pack.v0[ids], pack.e1[ids], pack.e2[ids]], 1)


def compare_brute(label, kind, s, auto, args, t, ids, occ=None):
    """A kind's closest hits (t, ids into s.tris) and occlusion against
    wide_bvh.brute_force_triangles on auto's W=4 tree: K5 (BOX_PAD-
    widened like the oracle's tree walk) with equal hit masks; K6, whose
    block cull is not widened as the TPU kernel's is not, on 99.9% of
    rays. t equal where both hit, the triangle the same but at ties."""
    import torch
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    tp, idp, _ = wb.brute_force_triangles(auto.accel, *args)
    hit, hitp = t < 3e37, tp < 3e37
    both = hit & hitp
    same_t = both & (t == tp)
    same_tri = same_t & (tri_rows(s.tris, ids) == tri_rows(auto.tris, idp)
                         ).all(1)
    n_both = max(int(both.sum()), 1)
    agree = float(hit.eq(hitp).float().mean())
    occ_ok = occ is None or torch.equal(occ, hitp)
    log(f"  {label}, {kind} vs brute force: {args[0].shape[0]} rays, hits "
        f"{int(hit.sum())} / {int(hitp.sum())}; hit masks agree on "
        f"{agree * 100:.3f}%; t equal on {int(same_t.sum())} of "
        f"{int(both.sum())} shared hits; same triangle on "
        f"{float(same_tri.sum()) / n_both * 100:.3f}%"
        + ("" if occ is None else f"; any-hit = brute force: {occ_ok}"))
    exact = kind == "pallas_sah"
    if (agree < (1.0 if exact else 0.999) or not occ_ok
            or int(same_t.sum()) < (1.0 if exact else 0.999) * n_both
            or float(same_tri.sum()) <= 0.99 * n_both):
        raise AssertionError(f"{label}: {kind} disagrees with brute force")


def phase_kind_kernels(device, steps, cam, sponza_rays):
    """Phase 9(b): K5 in its three modes and K6 against their plain
    versions on all the main path's primary rays and the lit shadow rays
    (or PLAIN_SUBSET of them, see plain_rays): t, id and counts equal;
    each timed beside its plain version, with its bound. Then K5 and K6
    against the brute force on phase 3's 8,192 rays."""
    import torch
    from cse168_raytracer_tpu_torch.ops import binary_bvh as bb
    from cse168_raytracer_tpu_torch.ops import tri_blocks as tb
    sah, blocks, auto = steps["pallas_sah"], steps["pallas"], steps["auto"]
    bvh = sah.accel
    saved = (dict(bb.LAUNCHES), dict(tb.LAUNCHES))
    o, d = primary_rays(cam, RES, RES, device)
    so, sd, stmax = shadow_rays(auto, o, d)
    rays = {"primary": (o, d, 0.0, 1e12), "lit shadow": (so, sd, 0.0, stmax)}
    log(f"[9b K5] binary SAH tree: {bvh.n_nodes} internal nodes, "
        f"{bvh.n_leaves} leaves, stack depth {bvh.stack_depth}")
    errs = {"closest": 0.0, "any": 0.0, "stats": 0.0}
    visits, subset = {}, {}
    for key, args in rays.items():
        m = plain_rays(f"K5 {key}", lambda *a: bb.walk_binary_plain(bvh, *a),
                       args, args[0].shape[0])
        subset[key] = m
        visits[key] = compare_plain(f"K5 {key} rays", bvh, head(args, m),
                                    errs, wb=bb)
    out = {}
    for mode, key in (("closest", "primary"), ("any", "lit shadow")):
        args, m = rays[key], subset[key]
        kern = bb.any_hit_triangles if mode == "any" else \
            bb.closest_hit_triangles
        plain = bb.any_hit_triangles_plain if mode == "any" else \
            bb.closest_hit_triangles_plain
        n = args[0].shape[0]
        ms = time_cuda(lambda: kern(bvh, *args), 10)
        stats_ms = time_cuda(lambda: kern(bvh, *args, with_stats=True), 10)
        plain_ms = time_cuda(lambda: plain(bvh, *head(args, m)), 2)
        stats_plain_ms = time_cuda(
            lambda: plain(bvh, *head(args, m), with_stats=True), 2)
        internal, leaves = visits[key][mode]
        # the visits scale to all n rays when the plain walk took a subset
        internal, leaves = internal * n // m, leaves * n // m
        w = binary_work(bvh, n, mode == "any", False, internal, leaves)
        ws = binary_work(bvh, n, mode == "any", True, internal, leaves)
        out[mode] = {"ms": ms, "rays": n, "plain_ms": plain_ms,
                     "plain_rays": m, **bound(w)}
        out["stats_" + mode] = {"ms": stats_ms, "plain_ms": stats_plain_ms,
                                "work": ws}
        log(f"[9b K5] {key} rays, {mode}: kernel {ms:.3f} ms, with counters "
            f"{stats_ms:.3f} ms, for {n} rays; walk_binary_plain "
            f"{plain_ms:.1f} ms ({stats_plain_ms:.1f} ms with counts) for "
            f"{m} rays; {internal} internal and {leaves} leaf visits "
            f"({internal / n:.3f} and {leaves / n:.3f} per ray)")
        log(f"[9b bound] K5 {mode}: {bound_line(w)}; kernel {ms:.3f} ms = "
            f"{out[mode]['bound_ms'] / ms * 100:.2f}% of bound")
    both = [out.pop("stats_" + m) for m in ("closest", "any")]
    total = {k: sum(b["work"][k] for b in both) for k in both[0]["work"]}
    out["stats"] = {"ms": sum(b["ms"] for b in both),
                    "plain_ms": sum(b["plain_ms"] for b in both),
                    "rays": 2 * RES * RES,
                    "plain_rays": subset["primary"] + subset["lit shadow"],
                    **bound(total)}
    log(f"[9b bound] K5 counting, both modes: {bound_line(total)}; kernels "
        f"{out['stats']['ms']:.3f} ms")
    out["errs"] = errs
    # traversal_stats on all the primary rays must give these counts
    out["visits_primary"] = (visits["primary"]["closest"]
                             if subset["primary"] == RES * RES else None)

    # K6: closest hit (any-hit is the closest hit) on both ray sets
    k6 = {"err": 0.0}
    for key, args in rays.items():
        n = args[0].shape[0]
        m = plain_rays(f"K6 {key}",
                       lambda *a: tb.closest_hit_plain(blocks.accel, *a),
                       args, n)
        t, ids = tb.closest_hit(blocks.accel, *args)
        tp, idp, pairs = tb.closest_hit_plain(blocks.accel, *head(args, m),
                                              count_pairs=True)
        torch.cuda.synchronize()
        if not (torch.equal(t[:m], tp) and torch.equal(ids[:m], idp)):
            raise AssertionError(f"K6 {key}: kernel and plain version differ "
                                 f"on {int((t[:m] != tp).sum())} t and "
                                 f"{int((ids[:m] != idp).sum())} ids")
        hit = tp < 3e37
        log(f"  K6 {key} rays: {m} rays, hits {int(hit.sum())}; kernel = "
            f"plain version in t and id; {pairs} (tile, block) pairs of "
            f"{-(-m // tb.RAY_TILE) * blocks.accel.num_blocks} passed the "
            "cull")
        if key != "primary":
            continue
        ms = time_cuda(lambda: tb.closest_hit(blocks.accel, *args), 10)
        plain_ms = time_cuda(lambda: tb.closest_hit_plain(
            blocks.accel, *head(args, m)), 1)
        pairs = pairs * n // m
        w = block_work(blocks.accel, n, pairs)
        k6.update({"ms": ms, "rays": n, "plain_ms": plain_ms,
                   "plain_rays": m, **bound(w)})
        log(f"[9b K6] primary rays: kernel {ms:.3f} ms for {n} rays; plain "
            f"version {plain_ms:.1f} ms for {m} rays; {pairs} (tile, block) "
            f"pairs passed the cull ({pairs / -(-n // tb.RAY_TILE):.3f} "
            f"blocks per 256-ray tile of {blocks.accel.num_blocks})")
        log(f"[9b bound] K6: {bound_line(w)}; kernel {ms:.3f} ms = "
            f"{k6['bound_ms'] / ms * 100:.2f}% of bound")
    out["k6"] = k6

    log("[9b brute force] phase 3's sponza_proxy rays")
    for key, args in sponza_rays.items():
        t, ids = bb.closest_hit_triangles(bvh, *args)
        occ = bb.any_hit_triangles(bvh, *args) < 3e37
        compare_brute(key, "pallas_sah", sah, auto, args, t, ids, occ)
        t, ids = tb.closest_hit(blocks.accel, *args)
        compare_brute(key, "pallas", blocks, auto, args, t, ids)
    bb.LAUNCHES.update(saved[0])
    tb.LAUNCHES.update(saved[1])
    return out


def phase_kind_stats(sah, static, cam, cfg, device, k5):
    """Phase 9(c): a forward render with collect_stats through "pallas_sah"
    (K5's counting mode on every traversal), and traversal_stats on the
    primary rays, which must give phase 9(b)'s K5 counts."""
    import torch
    from cse168_raytracer_tpu_torch.ops import binary_bvh as bb
    from cse168_raytracer_tpu_torch.ops.stats import traversal_stats
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    zero_launches(bb)
    with torch.no_grad():
        hdr, st = render_hdr(sah, static, cam, cfg.replace(collect_stats=True))
    torch.cuda.synchronize()
    launches = dict(bb.LAUNCHES)
    n_rays = (int(st.primary_rays) + int(st.shadow_rays)
              + int(st.secondary_rays))
    o, d = primary_rays(cam, RES, RES, device)
    ts = traversal_stats(sah.accel, o, d)
    log(f"[9c stats] pallas_sah render at {RES}x{RES} with collect_stats: "
        f"{n_rays} rays, {int(st.box_tests) / n_rays:.3f} box and "
        f"{int(st.tri_tests) / n_rays:.3f} triangle tests per ray; launches "
        f"{launches}; traversal_stats on the primary rays "
        f"{float(ts.box_tests_per_ray):.3f} box and "
        f"{float(ts.tri_tests_per_ray):.3f} triangle tests per ray")
    if not bool(hdr.isfinite().all()) or int(st.box_tests) <= 0 \
            or int(st.tri_tests) <= 0:
        raise AssertionError("pallas_sah stats render: image or counters")
    if launches["stats_closest"] < 1 or launches["stats_any"] < 1 \
            or launches["closest"] + launches["any"]:
        raise AssertionError("the stats render did not count through K5")
    if k5["visits_primary"] is not None:
        internal, leaves = k5["visits_primary"]
        if float(ts.box_tests_per_ray) != 2 * internal / (RES * RES) or \
                float(ts.tri_tests_per_ray) != bb.K * leaves / (RES * RES):
            raise AssertionError("traversal_stats differs from K5's counts")
    return launches


def phase_other_kinds(lit, static, cam, cfg, auto):
    """Phase 9(d): one forward render with each plain-PyTorch kind
    (block, bvh, packet) and with pallas_forest (Morton chunks of
    FOREST_CHUNK triangles through K1/K2) at KINDS_RES, against auto's
    image at the same size."""
    import torch
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    kcfg = cfg.replace(width=KINDS_RES, height=KINDS_RES)
    log(f"[9d kinds] forward renders at {KINDS_RES}x{KINDS_RES}, depth "
        f"{DEPTH}, lit")
    with torch.no_grad():
        ref, _ = render_hdr(auto, static, cam, kcfg)
    out = {}
    for kind, kw in (("block", {}), ("bvh", {}), ("packet", {}),
                     ("pallas_forest", {"chunk_tris": FOREST_CHUNK})):
        s, build_s = timed_attach(lit, kind, **kw)
        zero_launches(wb)
        t0 = time.perf_counter()
        with torch.no_grad():
            hdr, _ = render_hdr(s, static, cam, kcfg)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        share = pixel_agreement(hdr, ref)
        extra = (f"; {len(s.accel.chunks)} chunks, traverse_wide launches "
                 f"{dict(wb.LAUNCHES)}" if kind == "pallas_forest" else "")
        log(f"[9d kinds] {kind}: accel build {build_s:.3f} s, render "
            f"{sec:.3f} s (host clock, first run); {share * 100:.3f}% of "
            f"pixels within rtol 1e-4/atol 1e-5 of auto's" + extra)
        if share < 0.999 or not bool(hdr.isfinite().all()):
            raise AssertionError(f"{kind} render disagrees with auto's")
        if kind == "pallas_forest" and (len(s.accel.chunks) < 2 or min(
                wb.LAUNCHES["closest"], wb.LAUNCHES["any"]) < 1):
            raise AssertionError("pallas_forest did not walk its chunks "
                                 "through K1/K2")
        out[kind] = {"render_s": sec, "build_s": build_s}
        del s
    return out


def phase_k4(device, cam, cfg):
    """Phase 9(e): kernel K4, the W=8 tree (the >300k branch of auto), on
    _make_sponza_proxy(target_tris=400_000) lit: a fwd+bwd step at the
    main path's size counts its launches; on all 262,144 primary rays the
    closest+attr kernel equals walk_plain and is timed, with its bound."""
    import torch
    from cse168_raytracer_tpu_torch.models.geometry import pack_triangles
    from cse168_raytracer_tpu_torch.models.lights import LIGHT_POINT
    from cse168_raytracer_tpu_torch.models.materials import MaterialBuilder
    from cse168_raytracer_tpu_torch.models.scene import make_scene
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    from cse168_raytracer_tpu_torch.scenes.registry import _make_sponza_proxy
    mb = MaterialBuilder()
    white = mb.phong(kd=(0.8, 0.8, 0.8))
    big, static = make_scene(
        tris=pack_triangles([(_make_sponza_proxy(target_tris=400_000),
                              white)], device=device),
        materials=mb.build(device),
        lights=[dict(kind=LIGHT_POINT, position=LIT_LIGHT,
                     wattage=200.0)], device=device)
    big, build_s = timed_attach(big, "auto")
    bvh = big.accel
    if bvh.width != 8:
        raise AssertionError("the 400k-triangle scene did not get W=8")
    zero_launches(wb)
    hdr, grad, _ = fwd_bwd(big, static, cam, cfg)
    torch.cuda.synchronize()
    launches = dict(wb.LAUNCHES)
    if launches["closest"] < 1 or launches["any"] < 1:
        raise AssertionError("the W=8 step launched no K4 kernel")
    if not (bool(hdr.isfinite().all()) and bool(grad.abs().sum() > 0)):
        raise AssertionError("the W=8 step: image or gradient")
    o, d = primary_rays(cam, RES, RES, device)
    args = (o, d, 0.0, 1e12)
    errs = {"closest": 0.0, "any": 0.0, "stats": 0.0}
    visits = compare_plain("K4 primary rays", bvh, args, errs)
    compare_per_ray("K4 primary rays", bvh, args)
    n = o.shape[0]
    ms, per_ray_ms = time_turns(
        lambda: wb.closest_hit_triangles(bvh, *args),
        lambda: wb._launch_per_ray(bvh, *args, False), 10, "K4 closest")
    plain_ms = time_cuda(lambda: wb.closest_hit_triangles_plain(bvh, *args),
                         2)
    internal, leaves = visits["closest"]
    w = traversal_work(bvh, n, False, False, internal, leaves)
    log(f"[9e K4] {big.tris.n_valid} tris, W=8, {bvh.n_nodes} nodes, "
        f"{bvh.n_leaves} leaves, accel build {build_s:.3f} s; "
        f"{stack_line(bvh)}; one fwd+bwd "
        f"step launched {launches}; closest+attr kernel {ms:.3f} ms for {n} "
        f"primary rays (per-ray kernel {per_ray_ms:.3f} ms), walk_plain "
        f"{plain_ms:.1f} ms; {internal / n:.3f} "
        f"internal and {leaves / n:.3f} leaf visits per ray")
    log(f"[9e bound] K4: {bound_line(w)}; kernel {ms:.3f} ms = "
        f"{bound(w)['bound_ms'] / ms * 100:.2f}% of bound (per-ray kernel "
        f"{bound(w)['bound_ms'] / per_ray_ms * 100:.2f}%)")
    return {"ms": ms, "per_ray_ms": per_ray_ms, "rays": n,
            "plain_ms": plain_ms, "plain_rays": n,
            **bound(w), "launches": launches["closest"] + launches["any"],
            "err": errs["closest"]}


def phase_kinds(device, sponza_rays):
    """Phase 9: the A/B accelerator kinds on the card (a)-(e)."""
    lit, static, cam, cfg = kinds_scene(device)
    t0 = time.perf_counter()
    steps = phase_kind_steps(device, lit, static, cam, cfg)
    k5 = phase_kind_kernels(device, steps, cam, sponza_rays)
    stats_launches = phase_kind_stats(steps["pallas_sah"], static, cam, cfg,
                                      device, k5)
    others = phase_other_kinds(lit, static, cam, cfg, steps["auto"])
    del steps["pallas"], steps["pallas_sah"]
    k4 = phase_k4(device, cam, cfg)
    log(f"[9 kinds] phase 9 took {time.perf_counter() - t0:.1f} s")
    return steps, k5, stats_launches, others, k4


def main():
    device, card = phase_device()
    build_s, ptxas = phase_build()
    errs = {"closest": 0.0, "any": 0.0, "stats": 0.0}
    k3_cases, sponza_rays = phase_kernel_vs_oracle(device)
    # phase 7 runs on phase 3's trees while they are on the card; they
    # are freed before phase 4 measures the step's peak memory
    phase_k3(k3_cases, errs)
    del k3_cases
    main_run = phase_main_path(device)
    phase_card_vs_cpu(device)
    phase_children_on_card(device)
    timing = phase_plain_timing(device, main_run, errs)
    cli_runs, cli_launches = phase_cli(device, card)
    steps, k5, k5_stats_launches, _, k4 = phase_kinds(device, sponza_rays)
    import torch
    src = "cse168_raytracer_tpu_torch/csrc/traverse_wide.cu"
    replaces = "cse168_raytracer_tpu/ops/pallas_bvh.py:1056"
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "rays", "plain_rays")
    wkeys = keys + ("per_ray_ms",)

    def regs(*names):
        """Registers and spilled bytes of the card walk's kernels."""
        ks = [ptxas["traverse_warp " + x] for x in names]
        return {"registers": [k["registers"] for k in ks],
                "spill_bytes": [k["spill_stores"] + k["spill_loads"]
                                for k in ks]}
    src5 = "cse168_raytracer_tpu_torch/csrc/traverse_binary.cu"
    sah_launches = steps["pallas_sah step"]["launches"]
    kernels = [
        {"name": "traverse_wide closest+attr (W=4)", "route": "cuda",
         "source": src, "replaces": replaces,
         "launches": main_run["launches"]["closest"],
         "max_abs_err": errs["closest"], "library_ms": None,
         **{k: timing["closest"][k] for k in wkeys},
         **regs("W=4 closest")},
        {"name": "traverse_wide any-hit (W=4)", "route": "cuda",
         "source": src, "replaces": replaces,
         "launches": main_run["launches"]["any"],
         "max_abs_err": errs["any"], "library_ms": None,
         **{k: timing["any"][k] for k in wkeys}, **regs("W=4 any")},
        {"name": "traverse_wide with counters, closest+attr and any-hit "
                 "(K3)", "route": "cuda", "source": src,
         "replaces": "cse168_raytracer_tpu/ops/pallas_bvh.py:1020",
         "launches": (cli_launches["stats_closest"]
                      + cli_launches["stats_any"]),
         "max_abs_err": errs["stats"], "library_ms": None,
         **timing["stats"], **regs("W=4 closest stats", "W=4 any stats")},
        {"name": "traverse_wide W=8 tree (K4), timed closest+attr",
         "route": "cuda", "source": src,
         "replaces": "cse168_raytracer_tpu/ops/pallas_bvh.py:1331",
         "launches": k4["launches"], "max_abs_err": k4["err"],
         "library_ms": None, **{k: k4[k] for k in wkeys},
         **regs("W=8 closest", "W=8 any")},
        {"name": "traverse_binary closest (K5)", "route": "cuda",
         "source": src5,
         "replaces": "cse168_raytracer_tpu/ops/pallas_bvh.py:276",
         "launches": sah_launches["closest"],
         "max_abs_err": k5["errs"]["closest"], "library_ms": None,
         **{k: k5["closest"][k] for k in keys}},
        {"name": "traverse_binary any-hit (K5)", "route": "cuda",
         "source": src5,
         "replaces": "cse168_raytracer_tpu/ops/pallas_bvh.py:276",
         "launches": sah_launches["any"],
         "max_abs_err": k5["errs"]["any"], "library_ms": None,
         **{k: k5["any"][k] for k in keys}},
        {"name": "traverse_binary with counters, closest and any-hit (K5)",
         "route": "cuda", "source": src5,
         "replaces": "cse168_raytracer_tpu/ops/pallas_bvh.py:254",
         "launches": (k5_stats_launches["stats_closest"]
                      + k5_stats_launches["stats_any"]),
         "max_abs_err": k5["errs"]["stats"], "library_ms": None,
         **{k: k5["stats"][k] for k in keys}},
        {"name": "tri_blocks closest (K6)", "route": "cuda",
         "source": "cse168_raytracer_tpu_torch/csrc/tri_blocks.cu",
         "replaces": "cse168_raytracer_tpu/ops/pallas_intersect.py:105",
         "launches": steps["pallas step"]["launches"]["closest"],
         "max_abs_err": k5["k6"]["err"], "library_ms": None,
         **{k: k5["k6"][k] for k in keys}},
    ]
    a, b = (cli_runs[("sponza_proxy", x)] for x in ("a", "b"))
    log(f"[summary] main path "
        f"{main_run['registered']['ms']:.3f} ms/step as registered, "
        f"{main_run['lit']['ms']:.3f} ms/step lit; cli render (a) "
        f"{a['ms']:.3f} ms, (b) {b['ms_per_sample']:.3f} ms/sample; "
        f"pallas_sah step {steps['pallas_sah step']['ms']:.3f} ms, pallas "
        f"step {steps['pallas step']['ms']:.3f} ms (lit); card {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
