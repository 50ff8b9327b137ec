#!/usr/bin/env python3
"""Build and check the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

A check, not a benchmark: it times nothing. The port is timed end to
end by portbench/ (`python3 portbench/run.py --workload <cell> ...`),
and kernel against kernel by the package's profile_kinds and
profile_segsum, which time with time_cuda and device_ops below.

Builds the port's CUDA kernels from the sources in this checkout, one
nvcc each, all started together, and prints each kernel's registers,
shared memory and spills, failing if a card walk's instantiation (K1-K5)
or one of K6's kernels is missing from nvcc's report or spills (phase
2); holds the wide-tree kernel (the
card walk) against a brute-force oracle on the card, with a ray count
that is not a multiple of 32, dead rays inside warps and a mesh of tied
triangles among the cases (phase 3); drives the
port's main path (sponza_proxy at 512x512, trace depth 4, forward and
backward of sum(render_hdr) with respect to the material table kd, as
bench.py does for the JAX package; once as registered and once with its
light moved inside the atrium, see lit_sponza) (phase 4); checks the
card's renders against the CPU's, Whitted (bit for bit) and
path-traced, and the path-traced children on the card's own generator
(phase 5); holds the kernel, with and without its counters (K3),
against its plain PyTorch version walk_plain on every ray of the main
path, and against the oracle (phase 6),
and holds it against walk_plain on phase 3's rays (phase 7); drives the
command line's `render` on the card at 512x512 with --stats, Whitted
and path-traced through the thin lens at 16 spp, each as registered and
lit (phase 8); and runs
the A/B accelerator kinds on lit sponza_proxy (phase 9): (a) the fwd+bwd
step with "pallas_sah" (the binary tree, kernel K5) and "pallas" (the
Morton-block brute force, K6) against the "auto" step, (b) K5 in its
three modes and K6 against their plain versions on the main path's
primary and shadow rays (K6's passing (tile, block) pairs too), against
the brute force, and on phase 3's ragged,
dead-ray and tie cases, (c) a collect_stats render through K5 and
traversal_stats, (d) a forward render with each of "block", "bvh", "packet" and
"pallas_forest" against auto's, and (e) the W=8 kernel (K4) on the
400k-triangle proxy against walk_plain.
Phase 10 runs the textures and the registry at 512x512 and the
registered trace depth: (a) sponza_proxy's mesh written as an OBJ, read
back by the port's load_obj (vertices bit for bit) and rendered by
`cli render --scene sponza` with CSE168_SPONZA_OBJ naming it; (b) that
mesh with stone (bump-mapped), stem, cellular and cloud materials, a
glass sphere and an evaluated cloud environment, forward and forward +
backward w.r.t. kd, and against the CPU's image at 64x64 by
tests/test_golden.py's bar; (c) `cli render` of refract_spheres,
texture_plane, cellular_plane, spiral and sponza (the substitute); (d)
the K1/K2 launches of (a)-(c) and the peak device memory of (b).
Phase 11 runs photon mapping at the size users run (200,000 global and
200,000 caustic photons a light, samples 500, max_per_cell 32, up to
1200 batches) on photon_box, a stand-in for photon_cornell (its camera
and directional-area light, an open-front box of triangles, a glass
sphere of 19,800 triangles): (a) build_photon_maps on the card; (b) the
gather on 65,536 level-0 points, card against CPU (r'^2 bit for bit,
irradiance within rtol 1e-5); (c) trace_photon_batch on 65,536 photons,
card against CPU on one CPU generator's uniforms; (d) the 512² depth-10
render forward, fwd+bwd w.r.t. a gain on the stored powers and w.r.t.
kd, peak memory, launches, and the gather's device time against the
traversal's (torch.profiler, device_split); (e) that render at 64², card against CPU
by tests/test_golden.py's bar; (f) `cli render` with --photons,
--caustic-photons, --stats and --visualize-photons through cli.render
(built=), and the glassless box with --photons (K2's shadow rays); (g)
the gather kernel (csrc/photon_gather.cu) against its plain twin on
both maps at 262,144 level-0 points by torch.equal.
Phase 12 runs the rest of the port on lit sponza_proxy at 512x512, depth
4: (a) 16 curved bilinear patches in a material of their own, the patch
hits of the primary rays, the forward and fwd+bwd w.r.t. kd and w.r.t.
the patches' p11 corners, card against CPU at 64x64; (b)
render_hdr_sharded over local meshes of 1, 2 and 4 shards against
render_hdr, train_step_sharded's step against the one-shard
step, and one sharded step through an NCCL process group of world size
1; (c) two processes of `cli render --sharded` joined over gloo on the
one card (test_sphere), their frame against the one-process 2-shard
frame; (d) `cli render --progressive --path-tracing --spp 16
--checkpoint` stopped at 8 samples and resumed, against the straight
run, and `cli view` at 256x256, 8 spp; (e) InteractiveViewer's preview
and raytrace frames after keys and drags; (f) build_photon_maps over a
2-shard mesh on photon_box against phase 11's unsharded build. Phase
12's K1/K2 launches are added to the kernels line.
Phase 13 settles how the card rounds: (a) a census of every float32
elementwise op the renders use (the root, reciprocal, quotients, a
division by a Python number and vecmath.div_scalar, exp, sin, cos,
asin, acos, atan2, pow) on 2^20 inputs each, card against CPU and each
against the correctly rounded value; (b) vecmath.sqrt_rn on all 2^31
non-negative float32 inputs, on the card and on the CPU, rounded to
nearest; (c) a level's radiance accumulation with repeated pixels, on
mixed and on subnormal terms, the integrator's add_in_lane_order on the
card against the CPU's index_add; (d) the
Whitted forward of sphere, mixed_scene and refract_spheres at 512x512,
depths 4 and 10, lit sponza_proxy and test_sphere at 640x480 on the
card and on the CPU, equal by torch.equal, where a differing pixel
must trace to a transcendental that ROUNDED_BY_SCENE names for the
scene (PERF.md section 5 shows the same table); (e) the kd gradient of
sum(hdr) of sphere and mixed_scene (depths 4 and 10), lit sponza_proxy
(the main step) and refract_spheres at depth 4, card against CPU by
torch.equal, differences traced as in (d) to the ops
GRAD_ROUNDED_BY_SCENE names; (f) the photon path card against CPU:
photon tracing on 11(c)'s uniforms with the transcendentals on the CPU,
11(e)'s render and its photon-power gradient by torch.equal (or traced
to the ops PHOTON_ROUNDED names), and that gradient after the gather
kernel's forward and after its plain twin's; (g) the segment-sum kernel
(csrc/segment_sum.cu, the gradient scatters) against its plain version
and against itself, by
torch.equal, at the kd backward of the main step, a single run of all
its terms, ReattachRows' backward, a photon backward level, a run of
2^21 terms, random ids on 2^19 + 1 rows at 29 columns and runs of 1-64
terms; its sort against torch.sort's permutation, no sort with one row.
Each phase prints its own lines; any failure raises and exits non-zero.
The second-to-last line is a JSON object describing each kernel (its
source, launches, largest difference from its plain version, registers
and spills); the last line is {"ok": true, "device": {...}}. Without a
CUDA device it fails at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
KINDS_RES = 512      # phase 9(d)'s renders
FOREST_CHUNK = 65_536
TEXTURED_RES = 512   # phase 10's renders, at the registered trace depth
TEXTURED_CPU_RES = 64  # phase 10(b)'s card-vs-CPU image
# phase 11: the photon path at the README's and tools/golden_tpu.py's size
PHOTONS = 200_000          # global and caustic photons per light
PHOTON_CFG = dict(photons_per_light=PHOTONS, caustic_photons_per_light=PHOTONS,
                  photon_samples=500, photon_grid_max_per_cell=32,
                  photon_max_batches=1200)
PHOTON_RES = 512           # phase 11's renders, at trace depth 10
PHOTON_CPU_RES = 64        # phase 11(e)'s card-vs-CPU image
PHOTON_GATHER_POINTS = 65_536
# phase 11(g): the gather kernel at photon_box_render's level-0 size, the
# first diffuse hits of PHOTON_KERNEL_RES^2 primary rays
PHOTON_KERNEL_POINTS = 262_144
PHOTON_KERNEL_RES = 640
# 11(b), 11(g): candidates a chunk of the plain twin holds on the card
PHOTON_TWIN_CANDIDATES = 1 << 25
PHOTON_TRACE_N = 65_536
SPHERE_RINGS = 71          # the glass sphere: 4 x 71 x 70 = 19,880 triangles
N_PATCHES = 16             # phase 12(a)'s bilinear patches
PATCH_CPU_RES = 64         # phase 12(a)'s card-vs-CPU image
TWO_PROC_SCENE = "test_sphere"  # phase 12(c): lit as registered
VIEW_RES = 256             # phase 12(d)'s `cli view`
VIEW_SPP = 8
# phase 11(c): card and CPU photons that both stored, at rtol/atol 1e-4
TRACE_MASK_AGREE = 0.999
TRACE_CLOSE = 0.98
ASSET_FREE = ("refract_spheres", "texture_plane", "cellular_plane", "spiral",
              "sponza")


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
    from cse168_raytracer_tpu_torch.ops import (binary_bvh, cuda_build,
                                                photon_gather, sah,
                                                segment_sum, tri_blocks,
                                                wide_bvh)
    cuda_build.build_all()
    for mod in (wide_bvh, binary_bvh, tri_blocks, segment_sum,
                photon_gather):
        mod._kernel_lib()
    log(f"[2 build] {len(cuda_build.SOURCES)} kernel sources built and "
        "loaded")
    ptxas = {}
    for src in cuda_build.SOURCES:
        info = cuda_build.BUILD_INFO[src]
        log(f"[2 build] {src}: " + ("built by nvcc" if info["built"]
                                    else f"already built, {info['path']}"))
        for name, k in ptxas_kernels(info["log"]).items():
            ptxas[name] = k
            log(f"   ptxas: {name}: {k['registers']} registers, "
                f"{k['smem']} bytes static shared memory, stack frame "
                f"{k['stack']} bytes, spill stores {k['spill_stores']} "
                f"bytes, loads {k['spill_loads']} bytes")
    # the card walks' twelve instantiations (K1-K4's eight, K5's four),
    # K6's three kernels, the segmented sum's five and the photon
    # gather's two (candidates a lane), each reported and spilling
    # nothing: spills would put their operands in local memory
    names = [f"traverse_warp W={w} {mode}{stats}" for w in (4, 8)
             for mode in ("closest", "any") for stats in ("", " stats")]
    names += [f"traverse_binary_warp {mode}{stats}"
              for mode in ("closest", "any") for stats in ("", " stats")]
    for name in names + ["tri_blocks_cull", "tri_blocks_test",
                         "tri_blocks_finish", *SEGSUM_KERNELS,
                         *PHOTON_GATHER_KERNELS]:
        k = ptxas.get(name)
        if k is None:
            raise RuntimeError(f"phase 2: nvcc's report has no {name}")
        if k["spill_stores"] or k["spill_loads"]:
            raise RuntimeError(f"phase 2: {name} spills "
                               f"{k['spill_stores']} bytes of stores "
                               f"and {k['spill_loads']} of loads")
        # the gather keeps its candidates in registers: a stack frame
        # would be an array left in local memory
        if name in PHOTON_GATHER_KERNELS and k["stack"]:
            raise RuntimeError(f"phase 2: {name} keeps {k['stack']} bytes "
                               f"in local memory")
    sah.load_native()
    log(f"[2 build] native SAH builder {sah.native_library_path()} loaded")
    return ptxas


# csrc/segment_sum.cu's kernels
SEGSUM_KERNELS = ("segsum_hist", "segsum_sort_pass", "segsum_runs",
                  "segsum_tiles", "segsum_short")
# csrc/photon_gather.cu's instantiations, by candidates a lane
PHOTON_GATHER_KERNELS = tuple(f"photon_gather J={j}"
                              for j in (32, 64))


def ptxas_kernels(text):
    """{kernel: {"registers", "smem", "stack", "spill_stores",
    "spill_loads"}}
    from nvcc's -Xptxas -v report; the kernels named as "traverse_warp
    W=4 closest", "traverse_warp W=8 any stats", "traverse_binary_warp
    any stats", "tri_blocks_test", "segsum_short" or "photon_gather
    J=32" (its candidates a lane)."""
    import re
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", line)
        if m:
            cur = m.group(1)
            t = re.search(r"traverse_warpILi(\d)ELb([01])ELb([01])E", cur)
            b = re.search(r"traverse_binary_warpILb([01])ELb([01])E", cur)
            if t:
                cur = (f"traverse_warp W={t.group(1)} "
                       f"{'any' if t.group(2) == '1' else 'closest'}"
                       + (" stats" if t.group(3) == "1" else ""))
            elif b:
                cur = (f"traverse_binary_warp "
                       f"{'any' if b.group(1) == '1' else 'closest'}"
                       + (" stats" if b.group(2) == "1" else ""))
            elif re.search(r"tri_blocks_(cull|test|finish)", cur):
                cur = re.search(r"tri_blocks_(cull|test|finish)", cur).group(0)
            elif re.search(r"photon_gatherILi(\d+)E", cur):
                cur = "photon_gather J=" + re.search(
                    r"photon_gatherILi(\d+)E", cur).group(1)
            elif re.search(r"segsum_(hist|sort_pass|runs|tiles|short)", cur):
                cur = re.search(r"segsum_(hist|sort_pass|runs|tiles|short)",
                                cur).group(0)
            out.setdefault(cur, {"registers": 0, "smem": 0, "stack": 0,
                                 "spill_stores": 0, "spill_loads": 0})
            continue
        if cur is None:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("smem", r"(\d+) bytes smem"),
                         ("stack", r"(\d+) bytes stack frame"),
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


def phase_main_path(device):
    import torch
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.ops import segment_sum, wide_bvh
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    from cse168_raytracer_tpu_torch.scenes import build
    cfg = RenderConfig(width=RES, height=RES, trace_depth=DEPTH)
    scene, static, cam, cfg = build("sponza_proxy", cfg, device=device)
    scene = attach_accel(scene)
    log(f"[4 main path] sponza_proxy {scene.tris.n_valid} tris, "
        f"W={scene.accel.width}, {scene.accel.n_nodes} nodes, "
        f"{scene.accel.n_leaves} leaves; {stack_line(scene.accel)}")

    out = {"scene": scene, "static": static, "cam": cam}
    zero_launches(wide_bvh)
    zero_launches(segment_sum)
    for label, s in (("registered", scene), ("lit", lit_sponza(scene))):
        torch.cuda.reset_peak_memory_stats(device)
        hdr, grad, stats = fwd_bwd(s, static, cam, cfg)
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
        log(f"[4 main path] {label}: one fwd+bwd step; "
            f"{rays} rays = {int(stats.primary_rays)} primary + "
            f"{int(stats.shadow_rays)} shadow + "
            f"{int(stats.secondary_rays)} secondary; peak memory "
            f"{peak / 2**20:.1f} MiB; image mean {float(hdr.mean()):.6g} "
            f"max {float(hdr.max()):.6g}; "
            f"|grad| sum {float(grad.abs().sum()):.6g}")
    sums = launch_counts(segment_sum)
    out["launches"] = dict(launch_counts(wide_bvh), segment_sum=sums["sums"],
                           segment_sort=sums["sort"])
    log(f"[4 main path] kernel launches over both steps: {out['launches']}")
    for k in ("closest", "any", "segment_sum"):
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
    lobe-sampled children). The Whitted images must be equal bit for
    bit (phase 13 holds them so at full size); the path-traced pair,
    whose lobes take sin, cos, acos and pow, draws from one seeded CPU
    generator, so both consume the same uniforms, and is held by the
    per-pixel bar; its traversal counters (K3 on the card, walk_plain on
    the CPU) must agree too."""
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
        log(f"[5 card vs cpu] {name} 64x64: "
            f"{pixels_differ(card_hdr, cpu_hdr)} of 4096 pixels differ in "
            f"their bits, {share * 100:.3f}% within rtol 1e-4/atol 1e-5; "
            f"kd-gradient max rel diff {g_err:.3g}; card {card_st}, cpu "
            f"{cpu_st}")
        if not extra and not torch.equal(card_hdr, cpu_hdr):
            raise AssertionError(f"{name}: the card's Whitted render is not "
                                 "the CPU's bit for bit")
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
    saved = launch_counts(wb)
    st = {}
    with torch.no_grad():
        for depth in (0, DEPTH):
            cfg = RenderConfig(width=RES // 4, height=RES // 4,
                               trace_depth=depth, path_tracing=True,
                               trace_samples=1, collect_stats=True)
            set_launches(wb, {"stats_closest": 0})
            hdr, stats = render_hdr(scene, static, cam, cfg)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(hdr).all()):
                raise AssertionError("path-traced render: non-finite image")
            st[depth] = (int(stats.secondary_rays), int(stats.box_tests),
                         int(stats.tri_tests), launch_counts(wb)["stats_closest"])
    set_launches(wb, saved)
    (_, box0, tri0, n0), (sec, box, tri, n) = st[0], st[DEPTH]
    log(f"[5 children] mixed {RES // 4}x{RES // 4} path-traced on the "
        f"card's generator: {sec} secondary rays; their traversals "
        f"{box - box0} box and {tri - tri0} triangle tests "
        f"({n - n0} more K3 launches than at depth 0)")
    if sec <= 0 or box <= box0 or tri <= tri0 or n <= n0:
        raise AssertionError("the path-traced children did not go through "
                             "K3 on the card")


def phase_plain(device, main, errs):
    """Phase 6: on every ray of the main path (the registered scene's
    primary rays and its shadow rays, and the lit scene's shadow rays),
    the kernel with and without counters against walk_plain, exactly,
    and against the brute-force oracle on as many rays as its budget
    allows (plain_rays)."""
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    scene, cam = main["scene"], main["cam"]
    bvh = scene.accel
    saved = launch_counts(wb)
    o, d = primary_rays(cam, RES, RES, device)
    so, sd, stmax = shadow_rays(scene, o, d)
    lo, ld, ltmax = shadow_rays(lit_sponza(scene), o, d)
    rays = {"primary": (o, d, 0.0, 1e12), "shadow": (so, sd, 0.0, stmax),
            "lit shadow": (lo, ld, 0.0, ltmax)}
    log("[6 plain] the kernel against walk_plain and the oracle on the "
        "main path's rays")
    for k, args in rays.items():
        compare_plain(f"main-path {k} rays", bvh, args, errs)
    for key in ("primary", "shadow"):
        args = rays[key]
        m = plain_rays(f"oracle, main-path {key}",
                       lambda *a: wb.brute_force_triangles(bvh, *a), args,
                       args[0].shape[0])
        compare_oracle(f"main-path {key} rays", bvh, *head(args, m))
    set_launches(wb, saved)


def phase_k3(cases, errs):
    """Phase 7: kernel K3 against the plain walk on the card, on phase
    3's meshes and its 8,192 primary and shadow rays of the W=4 and W=8
    trees, in both modes: equal visit counts, and t, id and attributes
    as walk_plain and the kernel without counters give them."""
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    saved = launch_counts(wb)
    log("[7 K3]")
    for label, bvh, args in cases:
        compare_plain(label, bvh, args, errs)
    set_launches(wb, saved)


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
    zero_launches(wb)
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
                n_rays = res["rays"]
                log(f"[8 cli] {name} ({label}): {n_rays} rays, "
                    f"{int(st.box_tests) / n_rays:.3f} box and "
                    f"{int(st.tri_tests) / n_rays:.3f} triangle tests per "
                    f"ray; image mean {float(hdr.mean()):.6g}; card {card}")
    counted = launch_counts(wb)
    log(f"[8 cli] kernel launches over the four renders: {counted}")
    for k in ("stats_closest", "stats_any"):
        if counted[k] < 1:
            raise AssertionError(f"the command line launched no {k} kernel")
    return counted


# ---------------------------------------------------------------------------
# phase 9: the A/B accelerator kinds
# ---------------------------------------------------------------------------

def launch_counts(mod) -> dict:
    """A kernel module's launches by mode: the tracer's counters
    launch.<kernel>.<mode> (mod.LAUNCH names the kernel's)."""
    from cse168_raytracer_tpu_torch.utils import profiling
    return profiling.counts(mod.LAUNCH)


def set_launches(mod, values: dict) -> None:
    from cse168_raytracer_tpu_torch.utils import profiling
    profiling.set_counts(mod.LAUNCH, values)


def zero_launches(*mods):
    for mod in mods:
        set_launches(mod, dict.fromkeys(launch_counts(mod), 0))


def kinds_scene(device):
    """sponza_proxy lit, at the main path's size, without an accelerator."""
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.scenes import build
    cfg = RenderConfig(width=RES, height=RES, trace_depth=DEPTH)
    scene, static, cam, cfg = build("sponza_proxy", cfg, device=device)
    return lit_sponza(scene), static, cam, cfg


def grad_rel(g, ref):
    return float((g - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


def phase_kind_steps(device, lit, static, cam, cfg):
    """Phase 9(a): the fwd+bwd step with kind "pallas_sah" (kernel K5) and
    "pallas" (K6) against the "auto" step's image and kd gradient.
    Returns the scenes and each step's launches."""
    from cse168_raytracer_tpu_torch.ops import binary_bvh, tri_blocks
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    auto = attach_accel(lit, "auto")
    ref_hdr, ref_grad, _ = fwd_bwd(auto, static, cam, cfg)
    out = {"auto": auto}
    for kind, mod in (("pallas_sah", binary_bvh), ("pallas", tri_blocks)):
        s = attach_accel(lit, kind)
        zero_launches(mod, wb)
        hdr, grad, _ = fwd_bwd(s, static, cam, cfg)
        counted = launch_counts(mod)
        share, g_rel = pixel_agreement(hdr, ref_hdr), grad_rel(grad, ref_grad)
        log(f"[9a steps] {kind}: one fwd+bwd step at {RES}x{RES}, depth "
            f"{DEPTH}, lit; {share * 100:.3f}% of pixels within rtol "
            f"1e-4/atol 1e-5 of auto's; kd-gradient max rel diff "
            f"{g_rel:.3g}; launches {counted} (traverse_wide "
            f"{launch_counts(wb)})")
        if not (bool(hdr.isfinite().all()) and bool(grad.isfinite().all())):
            raise AssertionError(f"{kind} step: non-finite image or gradient")
        if share < 0.999 or g_rel > 1e-4:
            raise AssertionError(f"{kind} step disagrees with auto's")
        if sum(counted.values()) < 1 or sum(launch_counts(wb).values()):
            raise AssertionError(f"{kind} step did not go through its kernel")
        out[kind] = s
        out[kind + " step"] = {"launches": counted}
    return out


def plain_rays(label, fn, args, n):
    """How many of the n rays the plain version fn(*args) takes within
    PLAIN_BUDGET_S: all, or PLAIN_SUBSET when PLAIN_SUBSET of them, run
    once on the host clock, say that all would take longer. A budget for
    the check, not a measurement: it is not reported."""
    import torch
    if n <= PLAIN_SUBSET:
        return n
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*head(args, PLAIN_SUBSET))
    torch.cuda.synchronize()
    est_s = (time.perf_counter() - t0) * n / PLAIN_SUBSET
    if est_s <= PLAIN_BUDGET_S:
        return n
    log(f"  {label}: the plain version on all {n} rays would take over "
        f"its {PLAIN_BUDGET_S:.0f} s budget: held on the first "
        f"{PLAIN_SUBSET} rays")
    return PLAIN_SUBSET


def head(args, m):
    import torch
    return tuple(a[:m] if torch.is_tensor(a) else a for a in args)


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
    (or PLAIN_SUBSET of them, see plain_rays): t, id and counts equal.
    Then K5 and K6 against the brute force on phase 3's 8,192 rays."""
    from cse168_raytracer_tpu_torch.ops import binary_bvh as bb
    from cse168_raytracer_tpu_torch.ops import tri_blocks as tb
    sah, blocks, auto = steps["pallas_sah"], steps["pallas"], steps["auto"]
    bvh = sah.accel
    saved = (launch_counts(bb), launch_counts(tb))
    o, d = primary_rays(cam, RES, RES, device)
    so, sd, stmax = shadow_rays(auto, o, d)
    rays = {"primary": (o, d, 0.0, 1e12), "lit shadow": (so, sd, 0.0, stmax)}
    log(f"[9b K5] binary SAH tree: {bvh.n_nodes} internal nodes, "
        f"{bvh.n_leaves} leaves; {binary_stack_line(bvh)}")
    errs = {"closest": 0.0, "any": 0.0, "stats": 0.0}
    visits, subset = {}, {}
    for key, args in rays.items():
        m = plain_rays(f"K5 {key}", lambda *a: bb.walk_binary_plain(bvh, *a),
                       args, args[0].shape[0])
        subset[key] = m
        visits[key] = compare_plain(f"K5 {key} rays", bvh, head(args, m),
                                    errs, wb=bb)
    out = {"errs": errs}
    # traversal_stats on all the primary rays must give these counts
    out["visits_primary"] = (visits["primary"]["closest"]
                             if subset["primary"] == RES * RES else None)

    # K6: closest hit (any-hit is the closest hit) on both ray sets
    for key, args in rays.items():
        m = plain_rays(f"K6 {key}",
                       lambda *a: tb.closest_hit_plain(blocks.accel, *a),
                       args, args[0].shape[0])
        t, ids = tb.closest_hit(blocks.accel, *args)
        compare_k6(f"K6 {key} rays", blocks.accel, head(args, m),
                   (t[:m], ids[:m]))

    log("[9b brute force] phase 3's sponza_proxy rays")
    for key, args in sponza_rays.items():
        t, ids = bb.closest_hit_triangles(bvh, *args)
        occ = bb.any_hit_triangles(bvh, *args) < 3e37
        compare_brute(key, "pallas_sah", sah, auto, args, t, ids, occ)
        t, ids = tb.closest_hit(blocks.accel, *args)
        compare_brute(key, "pallas", blocks, auto, args, t, ids)
    kind_cases(device, sah, blocks, sponza_rays, errs)
    set_launches(bb, saved[0])
    set_launches(tb, saved[1])
    return out


def binary_stack_line(bvh):
    """K5's stack line: stack_depth two-word slots a thread in shared
    memory, checked against the tree's depth."""
    from cse168_raytracer_tpu_torch.ops import binary_bvh as bb
    lib = bb._kernel_lib()
    nbytes = bb._stack_smem_bytes(lib, bvh.stack_depth)
    if nbytes != bvh.stack_depth * 8 * lib.traverse_binary_threads():
        raise AssertionError("K5's stack is not the tree's depth")
    return (f"the card walk's stacks: {bvh.stack_depth} slots of a link "
            f"and an entry t a thread, {nbytes} bytes of dynamic shared "
            "memory a block")


def compare_k6(label, blocks, args, got=None):
    """K6 (or its outputs `got`) against closest_hit_plain on the same
    rays: t, id and the (tile, block) pairs that passed the cull, which
    the kernel counts in a launch of its own. Returns the pairs."""
    import torch
    from cse168_raytracer_tpu_torch.ops import tri_blocks as tb
    from cse168_raytracer_tpu_torch.ops.intersect import ray_bounds
    t, ids = tb.closest_hit(blocks, *args) if got is None else got
    tp, idp, pairs = tb.closest_hit_plain(blocks, *args, count_pairs=True)
    k_pairs = int(tb._launch(blocks, *args[:2],
                             *ray_bounds(args[0], *args[2:]),
                             count_pairs=True)[2].sum())
    if not (torch.equal(t, tp) and torch.equal(ids, idp)):
        raise AssertionError(f"{label}: kernel and plain version differ "
                             f"on {int((t != tp).sum())} t and "
                             f"{int((ids != idp).sum())} ids")
    if k_pairs != pairs:
        raise AssertionError(f"{label}: the kernel's tiles passed {k_pairs} "
                             f"(tile, block) pairs, the plain version's "
                             f"{pairs}")
    n = args[0].shape[0]
    log(f"  {label}: {n} rays, hits {int((tp < 3e37).sum())}; kernel = "
        f"plain version in t, id and the {pairs} (tile, block) pairs of "
        f"{-(-n // tb.RAY_TILE) * blocks.num_blocks} that passed the cull")
    return pairs


def kind_cases(device, sah, blocks, sponza_rays, errs):
    """Phase 9(b)'s edge cases for K5 (three modes) and K6, each against
    its plain version exactly: phase 3's ragged count (the last warp 31
    rays, the last tile 255) and dead rays in every warp and tile, on
    lit sponza_proxy; and a tie mesh (every hit ties, on lanes of one
    leaf or block and across them), where K5's t must also equal the
    brute force's and K6's on every hit both find."""
    import torch
    from cse168_raytracer_tpu_torch.models.geometry import pack_triangles
    from cse168_raytracer_tpu_torch.models.scene import make_scene
    from cse168_raytracer_tpu_torch.ops import binary_bvh as bb
    from cse168_raytracer_tpu_torch.ops import tri_blocks as tb
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    log("[9b cases] K5 and K6 against their plain versions")
    o, d = sponza_rays["primary"][:2]
    m = N_SUBSET - 1
    dead = torch.where(torch.arange(N_SUBSET, device=device) % 5 == 2,
                       -1.0, 1e12)
    cases = {f"ragged, {m} rays": (o[:m], d[:m], 0.0, 1e12),
             "dead every 5th": (o, d, 0.0, dead)}
    for key, args in cases.items():
        compare_plain(f"K5 {key}", sah.accel, args, errs, wb=bb)
        compare_k6(f"K6 {key}", blocks.accel, args)
    rng = np.random.default_rng(SEED + 9)
    tie, _ = make_scene(tris=pack_triangles([(tie_mesh(1000, rng), 0)],
                                            block=256, device=device),
                        device=device)
    n_tie = N_SUBSET // 2
    td = torch.as_tensor(rng.normal(0, 1, (n_tie, 3)).astype(np.float32),
                         device=device)
    td[:, 2] = td[:, 2].abs()
    td = (td / td.norm(dim=1, keepdim=True)).contiguous()
    to = torch.tensor([[0.0, 0.0, -5.0]], device=device).repeat(n_tie, 1)
    args = (to, td, 0.0, 1e10)
    k5, k6 = (attach_accel(tie, k).accel for k in ("pallas_sah", "pallas"))
    compare_plain("K5 ties", k5, args, errs, wb=bb)
    compare_k6("K6 ties", k6, args)
    auto = attach_accel(tie, "auto").accel
    tp = wb.brute_force_triangles(auto, *args)[0]
    t5 = bb.closest_hit_triangles(k5, *args)[0]
    t6 = tb.closest_hit(k6, *args)[0]
    both = (t6 < 3e37) & (tp < 3e37)
    in_leaf, across = tie_counts(auto, to, td, tp)
    agree6 = float((t6 < 3e37).eq(tp < 3e37).float().mean())
    log(f"  ties: {n_tie} rays, hits {int((tp < 3e37).sum())}; {in_leaf} "
        f"tie in the brute force's winning leaf, {across} across leaves; "
        f"K5's t = brute force's: {torch.equal(t5, tp)}; K6's hit masks "
        f"agree on {agree6:.5f}, t equal on shared hits: "
        f"{torch.equal(t6[both], tp[both])}")
    if not (torch.equal(t5, tp) and torch.equal(t6[both], tp[both])
            and agree6 >= 0.999 and in_leaf and across):
        raise AssertionError("ties: K5 or K6 differ from the brute force, "
                             "or the mesh makes no ties")


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
    counted = launch_counts(bb)
    n_rays = (int(st.primary_rays) + int(st.shadow_rays)
              + int(st.secondary_rays))
    o, d = primary_rays(cam, RES, RES, device)
    ts = traversal_stats(sah.accel, o, d)
    log(f"[9c stats] pallas_sah render at {RES}x{RES} with collect_stats: "
        f"{n_rays} rays, {int(st.box_tests) / n_rays:.3f} box and "
        f"{int(st.tri_tests) / n_rays:.3f} triangle tests per ray; launches "
        f"{counted}; traversal_stats on the primary rays "
        f"{float(ts.box_tests_per_ray):.3f} box and "
        f"{float(ts.tri_tests_per_ray):.3f} triangle tests per ray")
    if not bool(hdr.isfinite().all()) or int(st.box_tests) <= 0 \
            or int(st.tri_tests) <= 0:
        raise AssertionError("pallas_sah stats render: image or counters")
    if counted["stats_closest"] < 1 or counted["stats_any"] < 1 \
            or counted["closest"] + counted["any"]:
        raise AssertionError("the stats render did not count through K5")
    if k5["visits_primary"] is not None:
        internal, leaves = k5["visits_primary"]
        if float(ts.box_tests_per_ray) != 2 * internal / (RES * RES) or \
                float(ts.tri_tests_per_ray) != bb.K * leaves / (RES * RES):
            raise AssertionError("traversal_stats differs from K5's counts")
    return counted


def phase_other_kinds(lit, static, cam, cfg, auto):
    """Phase 9(d): one forward render with each plain-PyTorch kind
    (block, bvh, packet) and with pallas_forest (Morton chunks of
    FOREST_CHUNK triangles through K1/K2) at KINDS_RES, against auto's
    image at the same size."""
    import torch
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    kcfg = cfg.replace(width=KINDS_RES, height=KINDS_RES)
    log(f"[9d kinds] forward renders at {KINDS_RES}x{KINDS_RES}, depth "
        f"{DEPTH}, lit")
    with torch.no_grad():
        ref, _ = render_hdr(auto, static, cam, kcfg)
    for kind, kw in (("block", {}), ("bvh", {}), ("packet", {}),
                     ("pallas_forest", {"chunk_tris": FOREST_CHUNK})):
        s = attach_accel(lit, kind, **kw)
        zero_launches(wb)
        with torch.no_grad():
            hdr, _ = render_hdr(s, static, cam, kcfg)
        share = pixel_agreement(hdr, ref)
        extra = (f"; {len(s.accel.chunks)} chunks, traverse_wide launches "
                 f"{launch_counts(wb)}" if kind == "pallas_forest" else "")
        log(f"[9d kinds] {kind}: {share * 100:.3f}% of pixels within rtol "
            f"1e-4/atol 1e-5 of auto's" + extra)
        if share < 0.999 or not bool(hdr.isfinite().all()):
            raise AssertionError(f"{kind} render disagrees with auto's")
        if kind == "pallas_forest" and (len(s.accel.chunks) < 2 or min(
                launch_counts(wb)["closest"], launch_counts(wb)["any"]) < 1):
            raise AssertionError("pallas_forest did not walk its chunks "
                                 "through K1/K2")
        del s


def phase_k4(device, cam, cfg):
    """Phase 9(e): kernel K4, the W=8 tree (the >300k branch of auto), on
    _make_sponza_proxy(target_tris=400_000) lit: a fwd+bwd step at the
    main path's size counts its launches; on all 262,144 primary rays the
    kernel equals walk_plain in both modes, with and without its
    counters."""
    import torch
    from cse168_raytracer_tpu_torch.models.geometry import pack_triangles
    from cse168_raytracer_tpu_torch.models.lights import LIGHT_POINT
    from cse168_raytracer_tpu_torch.models.materials import MaterialBuilder
    from cse168_raytracer_tpu_torch.models.scene import make_scene
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    from cse168_raytracer_tpu_torch.scenes.registry import _make_sponza_proxy
    mb = MaterialBuilder()
    white = mb.phong(kd=(0.8, 0.8, 0.8))
    big, static = make_scene(
        tris=pack_triangles([(_make_sponza_proxy(target_tris=400_000),
                              white)], device=device),
        materials=mb.build(device),
        lights=[dict(kind=LIGHT_POINT, position=LIT_LIGHT,
                     wattage=200.0)], device=device)
    big = attach_accel(big, "auto")
    bvh = big.accel
    if bvh.width != 8:
        raise AssertionError("the 400k-triangle scene did not get W=8")
    zero_launches(wb)
    hdr, grad, _ = fwd_bwd(big, static, cam, cfg)
    torch.cuda.synchronize()
    counted = launch_counts(wb)
    if counted["closest"] < 1 or counted["any"] < 1:
        raise AssertionError("the W=8 step launched no K4 kernel")
    if not (bool(hdr.isfinite().all()) and bool(grad.abs().sum() > 0)):
        raise AssertionError("the W=8 step: image or gradient")
    log(f"[9e K4] {big.tris.n_valid} tris, W=8, {bvh.n_nodes} nodes, "
        f"{bvh.n_leaves} leaves; {stack_line(bvh)}; one fwd+bwd step "
        f"launched {counted}")
    o, d = primary_rays(cam, RES, RES, device)
    errs = {"closest": 0.0, "any": 0.0, "stats": 0.0}
    compare_plain("K4 primary rays", bvh, (o, d, 0.0, 1e12), errs)
    return {"launches": counted["closest"] + counted["any"],
            "err": errs["closest"]}


def phase_kinds(device, sponza_rays):
    """Phase 9: the A/B accelerator kinds on the card (a)-(e)."""
    lit, static, cam, cfg = kinds_scene(device)
    steps = phase_kind_steps(device, lit, static, cam, cfg)
    k5 = phase_kind_kernels(device, steps, cam, sponza_rays)
    stats_launches = phase_kind_stats(steps["pallas_sah"], static, cam, cfg,
                                      device, k5)
    phase_other_kinds(lit, static, cam, cfg, steps["auto"])
    del steps["pallas"], steps["pallas_sah"]
    k4 = phase_k4(device, cam, cfg)
    return steps, k5, stats_launches, k4


# ---------------------------------------------------------------------------
# phase 10: textures, bump maps, the OBJ loader and the registry's scenes
# ---------------------------------------------------------------------------

def write_proxy_obj(path):
    """sponza_proxy's 159,960-triangle mesh as an OBJ: vertices in %.9g,
    which float32 round-trips, a texture coordinate per vertex ((x, z) /
    2, the atrium's floor plan) and a normal per triangle. Returns the
    mesh."""
    from cse168_raytracer_tpu_torch.scenes.registry import _make_sponza_proxy
    mesh = _make_sponza_proxy()
    v = mesh["vertices"].astype(np.float64)
    f = mesh["tri_vidx"] + 1
    k = np.arange(1, f.shape[0] + 1)
    with open(path, "w") as fh:
        np.savetxt(fh, v, fmt="v %.9g %.9g %.9g")
        np.savetxt(fh, v[:, [0, 2]] / 2, fmt="vt %.9g %.9g")
        np.savetxt(fh, mesh["normals"][mesh["tri_nidx"][:, 0]],
                   fmt="vn %.9g %.9g %.9g")
        np.savetxt(fh, np.stack([f[:, 0], f[:, 0], k, f[:, 1], f[:, 1], k,
                                 f[:, 2], f[:, 2], k], 1),
                   fmt="f %d/%d/%d %d/%d/%d %d/%d/%d")
    return mesh


def textured_scene(mesh, device):
    """Phase 10(b)'s scene, built through the port's public API as
    mixed_scene is: the loaded mesh cut by triangle centroid x into four
    parts, stone (with its bump map), stem, cellular and cloud (3D, on
    world x and y); one glass sphere; a cloud environment that is
    evaluated (quirk_cloud_env_black=False); sponza's camera, and one
    200 W point light inside the atrium (LIT_LIGHT, as lit_sponza)."""
    from cse168_raytracer_tpu_torch.models import materials as m
    from cse168_raytracer_tpu_torch.models.geometry import (make_sphere_pool,
                                                            pack_triangles)
    from cse168_raytracer_tpu_torch.models.scene import make_scene
    from cse168_raytracer_tpu_torch.models.textures import (
        build_cellular_texture, make_environment)
    from cse168_raytracer_tpu_torch.render.camera import make_camera
    from cse168_raytracer_tpu_torch.scenes.registry import CLOUD_PARAMS_A3
    mb = m.MaterialBuilder()
    parts = [mb.textured(m.TEX_STONE, [1.0]), mb.textured(m.TEX_STEM, [2.0]),
             mb.textured(m.TEX_CELLULAR, [1.0], image_id=0),
             mb.textured(m.TEX_CLOUD, CLOUD_PARAMS_A3)]
    glass = mb.phong(kd=(0, 0, 0), kt=(0.9, 0.9, 0.9), shininess=100,
                     ior=1.5)
    cx = mesh["vertices"][mesh["tri_vidx"]].mean(1)[:, 0]
    part = np.digitize(cx, [-5.0, 1.0, 5.0])
    keys = ("tri_vidx", "tri_nidx", "tri_tidx")
    meshes = [({**mesh, **{k: mesh[k][part == i] for k in keys}}, mat)
              for i, mat in enumerate(parts)]
    scene, static = make_scene(
        tris=pack_triangles(meshes, device=device),
        spheres=make_sphere_pool([(3.5, 1.2, 0.0)], [0.9], [glass], device),
        materials=mb.build(device),
        lights=[dict(kind=0, position=LIT_LIGHT, color=(1, 1, 1),
                     wattage=200.0)],
        env=make_environment(cloud_params=CLOUD_PARAMS_A3,
                             quirk_cloud_env_black=False, device=device),
        cellulars=[build_cellular_texture(1000, 10, 10, seed=SEED,
                                          device=device)], device=device)
    cam = make_camera(eye=(8, 1.5, 1), look_at=(0, 2.5, -1), fov=55,
                      bg_color=(0, 0, 0.2), device=device)
    return scene, static, cam


def cli_render(name, tmp, label):
    """`cli render --scene name` at TEXTURED_RES as registered, its
    [scene] ... [out] lines on this script's output. Returns its result
    after checking the image's shape and values."""
    import torch
    from cse168_raytracer_tpu_torch import cli
    out = os.path.join(tmp, f"{name}.png")
    argv = ["render", "--scene", name, "--width", str(TEXTURED_RES),
            "--height", str(TEXTURED_RES), "--out", out]
    log(f"[10{label} cli] python -m cse168_raytracer_tpu_torch.cli "
        + " ".join(argv[:-2]))
    with contextlib.redirect_stderr(sys.stdout):
        res = cli.render(cli.parser().parse_args(argv))
    hdr = res["hdr"]
    if hdr.shape != (TEXTURED_RES, TEXTURED_RES, 3) or not bool(
            torch.isfinite(hdr).all()) or not os.path.getsize(out):
        raise AssertionError(f"cli {name}: no image, or a NaN in it")
    return res


def byte_diff(a, b):
    """|difference| of the sigmoid-tonemapped bytes of two HDR images."""
    from cse168_raytracer_tpu_torch.render.tonemap import (sigmoid_tonemap,
                                                           to_bytes)
    qa, qb = (to_bytes(sigmoid_tonemap(x.cpu())).numpy().astype(np.int32)
              for x in (a, b))
    return np.abs(qa - qb)


def phase_textured(device, card):
    """Phase 10 (a)-(d): the OBJ loader at full size, a textured and
    bump-mapped mesh forward and backward, and the asset-free scenes
    through the command line, all at TEXTURED_RES and the registered
    trace depth."""
    import torch
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.models.obj import load_obj
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the OBJ loader at full size, and sponza from it
        path = os.path.join(tmp, "sponza_proxy.obj")
        mesh = write_proxy_obj(path)
        loaded = load_obj(path)
        if loaded["vertices"].tobytes() != mesh["vertices"].tobytes():
            raise AssertionError("the loaded OBJ's vertices differ from "
                                 "sponza_proxy's")
        log(f"[10a obj] {loaded['tri_vidx'].shape[0]} triangles, "
            f"{loaded['vertices'].shape[0]} vertices written "
            f"({os.path.getsize(path) / 2**20:.1f} MiB) and loaded by "
            "load_obj; vertices equal sponza_proxy's bit for bit")
        zero_launches(wb)
        os.environ["CSE168_SPONZA_OBJ"] = path
        try:
            res = cli_render("sponza", tmp, "a")
        finally:
            del os.environ["CSE168_SPONZA_OBJ"]
        out["a"] = {"launches": launch_counts(wb)}
        log(f"[10a obj] sponza from the OBJ: {res['rays']} rays; launches "
            f"{out['a']['launches']}; card {card}")
        if min(out["a"]["launches"][k] for k in ("closest", "any")) < 1:
            raise AssertionError("sponza from the OBJ did not run K1 and K2")

    # (b) the textured, bump-mapped mesh
    zero_launches(wb)
    torch.cuda.reset_peak_memory_stats(device)
    scene, static, cam = textured_scene(loaded, device)
    scene = attach_accel(scene)
    cfg = RenderConfig(width=TEXTURED_RES, height=TEXTURED_RES)
    log(f"[10b textured] {scene.tris.n_valid} triangles in 4 textured "
        f"parts + a glass sphere, kinds {static.texture_kinds}, bump "
        f"{static.any_bump}; {TEXTURED_RES}x{TEXTURED_RES}, depth "
        f"{cfg.trace_depth}")
    with torch.no_grad():
        hdr, stats = render_hdr(scene, static, cam, cfg)
    if not bool(torch.isfinite(hdr).all()) or not bool(hdr.max() > hdr.min()):
        raise AssertionError("textured scene: NaN or constant image")
    _, grad, _ = fwd_bwd(scene, static, cam, cfg)
    peak = torch.cuda.max_memory_allocated(device)
    if not bool(torch.isfinite(grad).all()) or not bool(grad.abs().sum() > 0):
        raise AssertionError("textured scene: kd gradient non-finite or 0")
    rays = (int(stats.primary_rays) + int(stats.secondary_rays)
            + int(stats.shadow_rays))
    out["b"] = {"peak_mib": peak / 2**20}
    log(f"[10b textured] forward and fwd+bwd w.r.t. kd: {rays} rays "
        f"({int(stats.secondary_rays)} secondary); peak device memory "
        f"{peak / 2**20:.1f} MiB; image mean {float(hdr.mean()):.6g}; "
        f"|grad| sum {float(grad.abs().sum()):.6g}; card {card}")

    # card against CPU on the same scene, tests/test_golden.py's bar
    small = RenderConfig(width=TEXTURED_CPU_RES, height=TEXTURED_CPU_RES)
    with torch.no_grad():
        card_hdr = render_hdr(scene, static, cam, small)[0]
        cs, cst, ccam = textured_scene(loaded, torch.device("cpu"))
        cpu_hdr = render_hdr(attach_accel(cs), cst, ccam, small)[0]
    diff = byte_diff(card_hdr, cpu_hdr)
    within2, mean = float(np.mean(diff <= 2)), float(diff.mean())
    over1 = int((diff > 1).any(-1).sum())
    log(f"[10b textured] card vs CPU {TEXTURED_CPU_RES}x{TEXTURED_CPU_RES}: "
        f"{pixels_differ(card_hdr, cpu_hdr)} pixels differ in their bits; "
        f"{within2 * 100:.3f}% of bytes within +-2, mean |diff| {mean:.4f}, "
        f"{over1} of {diff.shape[0] * diff.shape[1]} pixels and "
        f"{int((diff > 1).sum())} of {diff.size} bytes outside +-1, max "
        f"{int(diff.max())}")
    if within2 < 0.999 or mean > 0.05:
        raise AssertionError("textured scene: card and CPU images disagree")
    out["b"]["launches"] = launch_counts(wb)
    del scene, cs

    # (c) the asset-free scenes as registered
    zero_launches(wb)
    out["c"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ASSET_FREE:
            before = launch_counts(wb)
            res = cli_render(name, tmp, "c")
            hdr = res["hdr"]
            if not bool(hdr.max() > hdr.min()):
                raise AssertionError(f"cli {name}: constant image")
            k12 = {k: launch_counts(wb)[k] - before[k] for k in ("closest", "any")}
            out["c"][name] = {"launches": k12}
            log(f"[10c cli] {name}: {res['rays']} rays, K1/K2 launches "
                f"{k12}; image mean {float(hdr.mean()):.6g}; card {card}")
    if min(out["c"]["spiral"]["launches"].values()) < 1:
        raise AssertionError("spiral's triangle did not go through K1 and K2")
    out["launches"] = {k: sum(out[p]["launches"][k] for p in ("a", "b"))
                       + sum(r["launches"][k] for r in out["c"].values())
                       for k in ("closest", "any")}
    log(f"[10d counts] K1/K2 launches: (a) "
        f"{ {k: out['a']['launches'][k] for k in ('closest', 'any')} }, (b) "
        f"{ {k: out['b']['launches'][k] for k in ('closest', 'any')} }, (c) "
        f"{ {n: r['launches'] for n, r in out['c'].items()} }; total "
        f"{out['launches']}; peak device memory of (b) "
        f"{out['b']['peak_mib']:.1f} MiB")
    return out


# ---------------------------------------------------------------------------
# phase 11: photon mapping
# ---------------------------------------------------------------------------

def quad(a, b, c, d, normal):
    """Two triangles (a, b, c) and (a, c, d) of a planar quad with one
    shading normal, in models/geometry's mesh-dict form."""
    v = np.asarray([a, b, c, d], np.float32)
    f = np.asarray([[0, 1, 2], [0, 2, 3]], np.int64)
    return {"vertices": v, "normals": np.tile(np.float32(normal), (4, 1)),
            "texcoords": np.zeros((0, 2), np.float32), "tri_vidx": f,
            "tri_nidx": f, "tri_tidx": np.full((2, 3), -1, np.int64)}


def uv_sphere(center, radius, rings):
    """A tessellated sphere with smooth (vertex) normals: `rings` bands
    of 2 * rings segments, 4 * rings * (rings - 1) triangles (one a
    segment in the two polar bands, two elsewhere)."""
    seg = 2 * rings
    th = np.linspace(0, np.pi, rings + 1)
    ph = np.linspace(0, 2 * np.pi, seg + 1)[:-1]
    n = np.stack([np.sin(th)[:, None] * np.cos(ph)[None],
                  np.cos(th)[:, None] * np.ones_like(ph)[None],
                  np.sin(th)[:, None] * np.sin(ph)[None]], -1).reshape(-1, 3)
    idx = np.arange((rings + 1) * seg).reshape(rings + 1, seg)
    nxt = np.roll(idx, -1, axis=1)
    tris = []
    for i in range(rings):
        a, b, c, d = idx[i], nxt[i], nxt[i + 1], idx[i + 1]
        if i > 0:                     # no sliver at the top pole
            tris.append(np.stack([a, b, c], 1))
        if i < rings - 1:             # nor at the bottom
            tris.append(np.stack([a, c, d], 1))
    f = np.concatenate(tris).astype(np.int64)
    v = (np.float64(center) + radius * n).astype(np.float32)
    return {"vertices": v, "normals": n.astype(np.float32),
            "texcoords": np.zeros((0, 2), np.float32), "tri_vidx": f,
            "tri_nidx": f, "tri_tidx": np.full_like(f, -1)}


def photon_box(device, glass=True):
    """The procedural stand-in for photon_cornell (whose Cornell OBJs
    come from the reference's assets): its camera and its
    directional-area light (scenes/registry.py: radius 1.5 at (2.5, 4.5,
    -1), aimed down, 50 W), an open-front box of triangles (white floor,
    ceiling and back wall, red left wall, green right wall, kd as there)
    and, with `glass`, a tessellated sphere of kd 0, kt 1, ior 1.5 (the
    glass of tests/test_photon.py) under the light. photon_cornell's
    water has kd (1, 1, 1), which sends every photon down the diffuse
    branch, so its caustic map would store nothing."""
    from cse168_raytracer_tpu_torch.models.geometry import pack_triangles
    from cse168_raytracer_tpu_torch.models.lights import \
        LIGHT_DIRECTIONAL_AREA
    from cse168_raytracer_tpu_torch.models.materials import MaterialBuilder
    from cse168_raytracer_tpu_torch.models.scene import make_scene
    from cse168_raytracer_tpu_torch.render.camera import make_camera
    mb = MaterialBuilder()
    white, red, green = (mb.phong(kd=kd) for kd in
                         ((1, 1, 1), (1, 0, 0), (0, 1, 0)))
    x0, x1, y0, y1, z0, z1 = 0.0, 5.0, 0.0, 5.0, -5.0, 1.0
    meshes = [
        (quad((x0, y0, z1), (x1, y0, z1), (x1, y0, z0), (x0, y0, z0),
              (0, 1, 0)), white),                              # floor
        (quad((x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1),
              (0, -1, 0)), white),                             # ceiling
        (quad((x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0),
              (0, 0, 1)), white),                              # back wall
        (quad((x0, y0, z0), (x0, y1, z0), (x0, y1, z1), (x0, y0, z1),
              (1, 0, 0)), red),                                # left
        (quad((x1, y0, z1), (x1, y1, z1), (x1, y1, z0), (x1, y0, z0),
              (-1, 0, 0)), green)]                             # right
    if glass:
        meshes.append((uv_sphere((2.5, 1.0, -1.0), 1.0, SPHERE_RINGS),
                       mb.phong(kd=(0, 0, 0), kt=(1, 1, 1), ior=1.5)))
    lights = [dict(kind=LIGHT_DIRECTIONAL_AREA, position=(2.5, 4.5, -1),
                   normal=(0, -1, 0), radius=1.5, color=(1, 1, 1),
                   wattage=50.0)]
    scene, static = make_scene(tris=pack_triangles(meshes, device=device),
                               materials=mb.build(device), lights=lights,
                               device=device)
    cam = make_camera(eye=(2.5, 3, 3), look_at=(2.5, 2.5, 0), fov=90,
                      bg_color=(0, 0, 0.2), device=device)
    return scene, static, cam


def photon_scene(device, glass=True):
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    scene, static, cam = photon_box(device, glass)
    return attach_accel(scene), static, cam


def launches_since(wb, before):
    """The wide-tree kernel's launches (K1, K2 and K3's two modes) since
    the counts `before`."""
    return {k: launch_counts(wb)[k] - before[k] for k in launch_counts(wb)}


def phase_photon_build(device, card, scene, static):
    """11(a): build_photon_maps on the card at the full configuration."""
    import torch
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    from cse168_raytracer_tpu_torch.ops.photon import build_photon_maps
    cfg = RenderConfig(**PHOTON_CFG)
    before = launch_counts(wb)
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    maps, stats = build_photon_maps(scene, static, cfg, gen,
                                    return_stats=True)
    launches = launches_since(wb, before)
    batch = 65536 if device.type == "cuda" else 10000
    batches = {n: st["emitted"] // batch for n, st in stats.items()}
    log(f"[11a build] build_photon_maps {PHOTONS} + {PHOTONS} photons a "
        f"light, samples {cfg.photon_samples}, max_per_cell "
        f"{cfg.photon_grid_max_per_cell}, max_batches "
        f"{cfg.photon_max_batches}: batches {batches}, wide-tree launches "
        f"{launches}; card {card}")
    for name, grid in (("global", maps.global_map),
                       ("caustic", maps.caustic_map)):
        st = stats[name]
        log(f"[11a build] {name}: emitted {st['emitted']}, stored "
            f"{st['stored']}, bounces {st['bounces']}, stored per level "
            f"{st['stored_per_level']}; kept {grid.n_valid}, radius "
            f"{float(grid.radius):.6g} (coarse {float(grid.coarse.radius):.6g})"
            f", folded rows {int((grid.weight > 1).sum())}")
        if grid.n_valid < PHOTONS:
            log(f"[11a build] {name} map holds {grid.n_valid} photons, "
                f"fewer than {PHOTONS}")
    return maps, dict(batches=batches, launches=launches, stats=stats)


def diffuse_points(scene, static, cam, n_points, res=PHOTON_RES):
    """The first n_points level-0 hits on diffuse materials of the
    res x res render's primary rays, in block order, with their
    normals."""
    import torch
    from cse168_raytracer_tpu_torch.models.materials import is_diffuse
    from cse168_raytracer_tpu_torch.ops.shading import trace_closest
    o, d = primary_rays(cam, res, res, scene.device)
    hit, surf = trace_closest(scene, static, o, d)
    lanes = torch.nonzero(hit.hit & is_diffuse(scene.materials,
                                                surf.material_id))[:, 0]
    if lanes.shape[0] < n_points:
        raise AssertionError(f"only {lanes.shape[0]} diffuse primary hits")
    lanes = lanes[:n_points]
    return surf.p[lanes].contiguous(), surf.n[lanes].contiguous()


def phase_photon_gather(card, maps, p, n):
    """11(b): the gather on the card and on the CPU, same maps and
    points: r'^2 and the level choice bit for bit, the irradiance within
    rtol 1e-5."""
    import torch
    from cse168_raytracer_tpu_torch.core.vecmath import safe_normalize
    from cse168_raytracer_tpu_torch.ops import photon as ph
    maps_cpu = maps.to(torch.device("cpu"))
    nu = safe_normalize(n)
    for name in ("global_map", "caustic_map"):
        grid, grid_c = getattr(maps, name), getattr(maps_cpu, name)
        chunk = twin_chunk(grid)
        card_out = ph.gather_levels(grid, p, nu, grid.power,
                                    grid.coarse.power, chunk)
        cpu_out = ph.gather_levels(grid_c, p.cpu(), nu.cpu(), grid_c.power,
                                   grid_c.coarse.power,
                                   ph.gather_chunk(grid_c))
        irr, irr_c = card_out[0].cpu(), cpu_out[0]
        for a, b, what in zip(card_out[1:], cpu_out[1:],
                              ("fine r'^2", "coarse r'^2", "level choice")):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"11b {name}: {what} differs between "
                                     "card and CPU")
        if not torch.allclose(irr, irr_c, rtol=1e-5, atol=0.0):
            raise AssertionError(f"11b {name}: irradiance differs")
        rel = float(((irr - irr_c).abs() / irr_c.abs().clamp(min=1e-30))
                    .max())
        log(f"[11b gather] {name}: {p.shape[0]} level-0 points, chunk "
            f"{chunk}: r'^2 of both levels and the level choice equal "
            f"bit for bit, irradiance max rel diff {rel:.3g} (bar 1e-5); "
            f"coarse level used at {int(card_out[3].sum())} points, mean "
            f"irradiance {float(irr.mean()):.6g}; card {card}")


def twin_chunk(grid):
    """Points a chunk of the plain twin holds on the card."""
    return max(1, PHOTON_TWIN_CANDIDATES // (27 * grid.max_per_cell))


def max_abs_diff(a, b):
    """The largest |a - b| of two tensors of one shape, in float64; 0
    where they are equal (infinities included)."""
    import torch
    a, b = a.double(), b.double()
    d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def phase_photon_kernel(card, scene, static, cam, maps):
    """11(g): the gather kernel (csrc/photon_gather.cu) against its plain
    twin (ops/photon.py gather_levels) on the card, on both maps, at
    photon_box_render's level-0 size (PHOTON_KERNEL_POINTS diffuse hits):
    irradiance, fine r'^2 and level choice by torch.equal, the coarse
    r'^2 where the coarse level is used, and the largest difference of
    any of them."""
    import torch
    from cse168_raytracer_tpu_torch.core.vecmath import safe_normalize
    from cse168_raytracer_tpu_torch.ops import photon as ph
    from cse168_raytracer_tpu_torch.ops import photon_gather as pg
    from cse168_raytracer_tpu_torch.utils import profiling
    p, n = diffuse_points(scene, static, cam, PHOTON_KERNEL_POINTS,
                          res=PHOTON_KERNEL_RES)
    n = safe_normalize(n)
    out = {"launches": 0, "max_abs_err": 0.0}
    for name in ("global_map", "caustic_map"):
        grid = getattr(maps, name)
        args = (grid, p, n, grid.power, grid.coarse.power)
        chunk = twin_chunk(grid)
        before = profiling.counts(pg.LAUNCH)["forward"]
        got = pg.gather(*args)
        torch.cuda.synchronize()
        out["launches"] += profiling.counts(pg.LAUNCH)["forward"] - before
        want = ph.gather_levels(*args, chunk)
        use_c = want[3]
        same = [torch.equal(got[0], want[0]), torch.equal(got[1], want[1]),
                torch.equal(got[3], use_c),
                torch.equal(got[2][use_c], want[2][use_c])]
        err = max(max_abs_diff(got[0], want[0]),
                  max_abs_diff(got[1], want[1]),
                  max_abs_diff(got[2][use_c], want[2][use_c]))
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if not all(same):
            raise AssertionError(f"11g {name}: kernel and twin differ "
                                 f"(irradiance, r'^2, level, coarse r'^2: "
                                 f"{same}; max abs diff {err})")
        log(f"[11g gather kernel] {name}: {p.shape[0]} level-0 points, "
            f"max_per_cell {grid.max_per_cell}, coarse level used at "
            f"{int(use_c.sum())}: kernel = twin by torch.equal (max abs "
            f"diff {err}; twin {chunk} points a chunk); card {card}")
    return out


def phase_photon_trace(device, card, scene, static, cpu_scene, cpu_static):
    """11(c): trace_photon_batch on the card and on the CPU with the same
    uniforms, drawn from one CPU generator."""
    import torch
    from cse168_raytracer_tpu_torch.ops import photon as ph
    out = {}
    for caustic in (False, True):
        gen = torch.Generator().manual_seed(SEED + int(caustic))
        u = ph.draw_photon_uniforms(gen, PHOTON_TRACE_N, 5, False)
        u_card = ph.PhotonUniforms(**{
            f.name: None if getattr(u, f.name) is None
            else getattr(u, f.name).to(device) for f in dataclasses.fields(u)})
        a = ph.trace_photon_batch(scene, static, 0, caustic, False, u_card)
        b = ph.trace_photon_batch(cpu_scene, cpu_static, 0, caustic, False,
                                  u)
        am, bm = a.mask.cpu(), b.mask
        agree = float((am == bm).float().mean())
        both = am & bm
        close = {}
        for f in ("pos", "dir", "power"):
            x, y = getattr(a, f).cpu()[both], getattr(b, f)[both]
            ok = torch.isclose(x, y, rtol=1e-4, atol=1e-4).all(-1)
            close[f] = float(ok.float().mean())
        dbounce = (a.bounces.cpu() - b.bounces).abs().max()
        name = "caustic" if caustic else "global"
        log(f"[11c trace] {name}: {PHOTON_TRACE_N} photons x 6 levels: "
            f"stored masks agree on "
            f"{agree * 100:.4f}% of slots ({int(am.sum())} card, "
            f"{int(bm.sum())} CPU stored); of {int(both.sum())} slots both "
            f"stored, within rtol/atol 1e-4: pos {close['pos'] * 100:.3f}%, "
            f"dir {close['dir'] * 100:.3f}%, power "
            f"{close['power'] * 100:.3f}%; bounces differ by at most "
            f"{int(dbounce)}; card {card}")
        if agree < TRACE_MASK_AGREE or min(close.values()) < TRACE_CLOSE:
            raise AssertionError(f"11c {name}: card and CPU photons disagree")
        out[name] = dict(agree=agree, close=close, uniforms=u, cpu_batch=b)
    return out


def gain_step(scene, static, cam, cfg):
    """sum(hdr) and its gradient w.r.t. a per-channel gain on both maps'
    stored (fine-level) powers."""
    import torch
    gain = torch.ones(3, device=scene.device, requires_grad=True)
    pm = scene.photons
    maps = pm.replace(**{n: getattr(pm, n).replace(
        power=getattr(pm, n).power * gain[None, :])
        for n in ("global_map", "caustic_map")})
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    hdr, _ = render_hdr(scene.replace(photons=maps), static, cam, cfg)
    hdr.sum().backward()
    return hdr.detach(), gain.grad


def device_split(events, mark):
    """Device time of a traced run, from torch.profiler's events: the
    kernels (each once, by name and time range), their summed and their
    union ("busy") time, the union of the kernels inside the device-side
    ranges of the record_function `mark`, and that of the wide-tree
    walk's kernels. A record_function range shows on the device as a
    user annotation spanning the kernels launched inside it; it is a
    window, not work, so it counts in no kernel time. Kernels run in
    order on one stream here, so those inside a mark's window are the
    mark's own. Times in ms."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    kernels, windows = set(), []
    for e in events:
        if e.device_type != cuda:
            continue
        span = (e.time_range.start, e.time_range.end)
        if getattr(e, "is_user_annotation", False) or e.name == mark:
            if e.name == mark:
                windows.append(span)
            continue
        kernels.add((e.name,) + span)

    def inside(s, e):
        return [(max(s, ws), min(e, we)) for ws, we in windows
                if min(e, we) > max(s, ws)]

    spans = [(s, e) for _, s, e in kernels]
    gather = [c for s, e in spans for c in inside(s, e)]
    walk = [(s, e) for n, s, e in kernels if "traverse" in n]
    return dict(kernels=len(kernels),
                kernel_ms=sum(e - s for s, e in spans) / 1e3,
                busy_ms=_union_us(spans) / 1e3,
                gather_ms=_union_us(gather) / 1e3,
                gather_ranges=len(windows),
                traverse_ms=_union_us(walk) / 1e3)


def _union_us(ranges):
    """Total length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(ranges):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def phase_photon_render(device, card, scene, static, cam, maps):
    """11(d): the photon-mapped render at PHOTON_RES, depth 10: forward,
    fwd+bwd w.r.t. the stored-power gain and w.r.t. kd, peak memory,
    the wide tree's and the gather kernel's launches, and the gather's
    share of the device time against K1/K2's (device_split)."""
    import torch
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.ops import photon_gather as pg
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    from cse168_raytracer_tpu_torch.render import integrator
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    from cse168_raytracer_tpu_torch.utils import profiling
    cfg = RenderConfig(width=PHOTON_RES, height=PHOTON_RES, trace_depth=10)
    lit = scene.replace(photons=maps)
    out = {}
    before = launch_counts(wb)
    zero_launches(pg)
    gathers = profiling.counts("photon").get("gathers", 0)
    torch.cuda.reset_peak_memory_stats(device)
    with torch.no_grad():
        hdr, stats = render_hdr(lit, static, cam, cfg)
        base = render_hdr(scene, static, cam, cfg)[0]
    out["fwd_launches"] = launches_since(wb, before)
    # the one forward with the maps
    out["gather_launches"] = launch_counts(pg)["forward"]
    gathers = profiling.counts("photon").get("gathers", 0) - gathers
    if out["gather_launches"] != gathers or gathers == 0:
        raise AssertionError(f"11d: {out['gather_launches']} gather kernel "
                             f"launches for {gathers} gathers")
    if not bool(torch.isfinite(hdr).all()) or not bool(
            (hdr >= base - 1e-6).all()) or not float(hdr.sum()) > float(
            base.sum()):
        raise AssertionError("11d: the photon maps do not brighten the "
                             "render, or a NaN")
    rays = (int(stats.primary_rays) + int(stats.secondary_rays)
            + int(stats.shadow_rays))
    _, g = gain_step(lit, static, cam, cfg)
    if not bool(torch.isfinite(g).all()) or not bool((g.abs() > 0).all()):
        raise AssertionError(f"11d: stored-power gain gradient {g}")
    _, kd_grad, _ = fwd_bwd(lit, static, cam, cfg)
    if not bool(torch.isfinite(kd_grad).all()):
        raise AssertionError("11d: kd gradient non-finite")
    out["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
    out["launches"] = launches_since(wb, before)
    out["all_gather_launches"] = launch_counts(pg)["forward"]
    log(f"[11d render] {PHOTON_RES}x{PHOTON_RES}, depth 10, both maps: "
        f"forward, and fwd+bwd w.r.t. the stored-power gain (gradient "
        f"{g.tolist()}) and w.r.t. kd; {rays} rays; peak device memory "
        f"{out['peak_mib']:.1f} MiB; wide-tree launches of the forwards "
        f"with and without the maps {out['fwd_launches']}, of all (d)'s "
        f"renders {out['launches']}; gather kernel launches of the "
        f"forward with the maps {out['gather_launches']}, of all (d)'s "
        f"renders {out['all_gather_launches']}; image mean "
        f"{float(hdr.mean()):.6g} (without the maps "
        f"{float(base.mean()):.6g}); card {card}")

    # the gather's share of the device time against the traversal's, one
    # forward
    real = integrator.irradiance_estimate

    def marked(*a):
        with torch.profiler.record_function("photon_gather"):
            return real(*a)

    integrator.irradiance_estimate = marked
    try:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
            render_hdr(lit, static, cam, cfg)
            torch.cuda.synchronize()
    finally:
        integrator.irradiance_estimate = real
    split = device_split(prof.events(), "photon_gather")
    if split["busy_ms"] > 0:
        busy = split["busy_ms"]
        log(f"[11d render] torch.profiler, one forward: {split['kernels']} "
            f"device kernels, {split['kernel_ms']:.3f} ms of kernel time, "
            f"busy {busy:.3f} ms; the gather's kernels "
            f"{split['gather_ms']:.3f} ms "
            f"({100 * split['gather_ms'] / busy:.1f}% of busy, "
            f"{split['gather_ranges']} ranges on the device), K1/K2 "
            f"{split['traverse_ms']:.3f} ms "
            f"({100 * split['traverse_ms'] / busy:.1f}%)")
        if split["kernel_ms"] > 1.01 * busy:
            log("[11d render] device kernels overlap: the gather's window "
                "may hold kernels of other work")
        if split["gather_ranges"] == 0:
            log("[11d render] the profiler left no device-side range of "
                "the gather: its device share is not measured")
    else:
        log("[11d render] torch.profiler recorded no device time: the "
            "gather's device share is not measured")
    return out


def phase_photon_cpu(card, scene, static, cam, maps, cpu_scene, cpu_static,
                     cpu_cam):
    """11(e): the same render at PHOTON_CPU_RES on the card and on the
    CPU with the same maps, by tests/test_golden.py's bar."""
    import torch
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    small = RenderConfig(width=PHOTON_CPU_RES, height=PHOTON_CPU_RES,
                         trace_depth=10)
    with torch.no_grad():
        card_hdr = render_hdr(scene.replace(photons=maps), static, cam,
                              small)[0]
        cpu_hdr = render_hdr(cpu_scene.replace(photons=maps.to("cpu")),
                             cpu_static, cpu_cam, small)[0]
    diff = byte_diff(card_hdr, cpu_hdr)
    within2, mean = float(np.mean(diff <= 2)), float(diff.mean())
    log(f"[11e card vs CPU] {PHOTON_CPU_RES}x{PHOTON_CPU_RES}, depth 10, "
        f"both maps: {pixels_differ(card_hdr, cpu_hdr)} pixels differ in "
        f"their bits; {within2 * 100:.3f}% of bytes within +-2, mean |diff| "
        f"{mean:.4f}, {int((diff > 1).sum())} of {diff.size} bytes outside "
        f"+-1, max {int(diff.max())}; card {card}")
    if within2 < 0.999 or mean > 0.05:
        raise AssertionError("11e: card and CPU photon renders disagree")
    return dict(within2=within2, mean=mean, card_hdr=card_hdr.cpu(),
                cpu_hdr=cpu_hdr)


def read_ppm(path):
    with open(path, "rb") as f:
        if f.readline().strip() != b"P6":
            raise AssertionError(f"{path}: not a binary PPM")
        w, h = map(int, f.readline().split())
        f.readline()
        return np.frombuffer(f.read(), np.uint8).reshape(h, w, 3)


def phase_photon_cli(card, device):
    """11(f): `cli render` with the photon options through cli.render on
    the stand-in (built=), and its glassless box with --photons alone,
    whose shadow rays take K2 (with --stats every traversal of the
    render takes K3)."""
    import io
    from cse168_raytracer_tpu_torch import cli
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for glass in (True, False):
            label = "photon box" + ("" if glass else " without glass")
            ov = os.path.join(tmp, "overlay.ppm")
            argv = ["render", "--scene", "photon_box", "--width",
                    str(PHOTON_RES), "--height", str(PHOTON_RES), "--photons",
                    str(PHOTONS), "--out", os.path.join(tmp, "out.png")]
            if glass:
                argv += ["--caustic-photons", str(PHOTONS), "--stats",
                         "--visualize-photons", ov]
            log(f"[11f cli] {label}: cli.render(parse_args({argv[2:-2]}), "
                "built=...)")
            before = launch_counts(wb)
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                res = cli.render(cli.parser().parse_args(argv),
                                 built=photon_box(device, glass))
            log(err.getvalue().rstrip())
            text = err.getvalue()
            need = ["[photons] traced in"]
            if glass:
                need += ["[stats] photons global:", "[stats] photons caustic:",
                         "[viz] wrote"]
            for line in need:
                if line not in text:
                    raise AssertionError(f"11f {label}: no `{line}` line")
            launches = launches_since(wb, before)
            out["glass" if glass else "plain"] = dict(launches=launches)
            log(f"[11f cli] {label}: {res['rays']} rays, wide-tree launches "
                f"{launches}; card {card}")
            if glass:
                img = read_ppm(ov)
                green = int(((img[..., 1] == 255) & (img[..., 0] == 40)).sum())
                red = int(((img[..., 0] == 255) & (img[..., 1] == 40)).sum())
                log(f"[11f cli] overlay: {green} green and {red} red pixels")
                if green == 0 or red == 0:
                    raise AssertionError("11f: the overlay lacks green or "
                                         "red photons")
            elif launches["any"] < 1:
                raise AssertionError("11f: the glassless box ran no K2")
    return out


def phase_photons(device, card):
    """Phase 11 (a)-(g): the photon path at the size users run."""
    import torch
    scene, static, cam = photon_scene(device)
    log(f"[11 photons] stand-in for photon_cornell: {scene.tris.n_valid} "
        f"triangles (the box's 10 and a glass sphere's "
        f"{scene.tris.n_valid - 10}), W={scene.accel.width} tree")
    maps, build = phase_photon_build(device, card, scene, static)
    p, n = diffuse_points(scene, static, cam, PHOTON_GATHER_POINTS)
    phase_photon_gather(card, maps, p, n)
    kernel = phase_photon_kernel(card, scene, static, cam, maps)
    cpu = torch.device("cpu")
    cpu_scene, cpu_static, cpu_cam = photon_scene(cpu)
    trace = phase_photon_trace(device, card, scene, static, cpu_scene,
                               cpu_static)
    render = phase_photon_render(device, card, scene, static, cam, maps)
    match = phase_photon_cpu(card, scene, static, cam, maps, cpu_scene,
                             cpu_static, cpu_cam)
    maps_cpu = maps.to(cpu)
    del scene, cpu_scene, maps
    cli_runs = phase_photon_cli(card, device)
    # the photon path's launches: the map build, the renders and the
    # command line (not the comparisons of (b), (c), (e))
    launches = {k: build["launches"][k] + render["launches"][k] + sum(
        r["launches"][k] for r in cli_runs.values())
        for k in build["launches"]}
    log(f"[11 photons] wide-tree launches on the photon path: (a) "
        f"{build['launches']}, (d) {render['launches']}, (f) "
        f"{ {n: r['launches'] for n, r in cli_runs.items()} }; total "
        f"{launches}")
    return dict(build=build, kernel=kernel, trace=trace, render=render,
                match=match, launches=launches, maps_cpu=maps_cpu)


# ---------------------------------------------------------------------------
# phase 12: bilinear patches, sharding, progressive rendering, the viewer
# ---------------------------------------------------------------------------

def patch_pool(device):
    """N_PATCHES curved patches, a 4 x 4 grid of saddles at x ~ -2 facing
    the camera (+x), lit from the light at (0, 8, 0)."""
    from cse168_raytracer_tpu_torch.models.geometry import make_blpatch_pool
    c = [[], [], [], []]
    for i in range(4):
        for j in range(4):
            x = -2.0 - 0.15 * ((i + j) % 2)
            z0, y0 = -3.0 + 1.15 * i, 1.0 + 0.8 * j
            c[0].append((x, y0, z0))
            c[1].append((x, y0 + 0.7, z0))               # p10: Su along y
            c[2].append((x, y0, z0 + 1.0))               # p01: Sv along z
            c[3].append((x + 0.4, y0 + 0.7, z0 + 1.0))   # p11 bent to +x
    return make_blpatch_pool(*c, [0] * N_PATCHES, device=device)


def patch_scene(device):
    """Lit sponza_proxy at RES x RES, depth DEPTH, with patch_pool's
    patches in a material of their own (orange, diffuse)."""
    import torch
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.models.scene import make_static
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    from cse168_raytracer_tpu_torch.scenes import build
    cfg = RenderConfig(width=RES, height=RES, trace_depth=DEPTH)
    scene, static, cam, cfg = build("sponza_proxy", cfg, device=device)
    scene = lit_sponza(scene)
    mats = scene.materials
    new = {f.name: torch.cat([getattr(mats, f.name), getattr(mats, f.name)[:1]])
           for f in dataclasses.fields(mats)}
    new["kd"][-1] = torch.tensor([0.9, 0.5, 0.2])
    mats = mats.replace(**new)
    pool = patch_pool(device)
    pool.material_id.fill_(mats.num_materials - 1)
    scene = attach_accel(scene.replace(materials=mats, blpatches=pool))
    return scene, make_static(mats, scene.lights), cam, cfg


def golden_or_exact(label, a, b, rtol=1e-5, atol=1e-6):
    """Which bar two HDR images meet: "rtol 1e-5" per pixel, else
    tests/test_golden.py's on their bytes; raises when neither holds."""
    import torch
    err = float((a - b).abs().max())
    if torch.allclose(a, b, rtol=rtol, atol=atol):
        bar = (f"rtol {rtol:g} (max |diff| {err:.3g}; {pixels_differ(a, b)} "
               "pixels differ in their bits)")
    else:
        diff = byte_diff(a, b)
        within2, mean = float(np.mean(diff <= 2)), float(diff.mean())
        if within2 < 0.999 or mean > 0.05:
            raise AssertionError(f"{label}: images disagree (max |diff| "
                                 f"{err:.3g}, {within2 * 100:.3f}% of bytes "
                                 f"within +-2, mean {mean:.4f})")
        bar = (f"the golden bar ({within2 * 100:.3f}% of bytes within +-2, "
               f"mean {mean:.4f}; max |diff| {err:.3g})")
    log(f"  {label}: {bar}")
    return bar, err


def phase_patches(device, card):
    """12(a): lit sponza_proxy with N_PATCHES patches: the patch hits, the
    forward and the fwd+bwd w.r.t. kd and a corner, card against CPU."""
    import torch
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    from cse168_raytracer_tpu_torch.ops.intersect import PRIM_BLPATCH
    from cse168_raytracer_tpu_torch.ops.shading import trace_closest
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    scene, static, cam, cfg = patch_scene(device)
    o, d = primary_rays(cam, RES, RES, device)
    with torch.no_grad():
        hit, _ = trace_closest(scene, static, o, d)
    n_patch = int((hit.prim_type == PRIM_BLPATCH).sum())
    log(f"[12a patches] lit sponza_proxy {scene.tris.n_valid} triangles + "
        f"{N_PATCHES} bilinear patches, {RES}x{RES}, depth {DEPTH}: "
        f"{n_patch} of {RES * RES} primary rays hit a patch")
    if n_patch == 0:
        raise AssertionError("12a: no primary ray hits a patch")
    before = launch_counts(wb)
    torch.cuda.reset_peak_memory_stats(device)
    with torch.no_grad():
        hdr, stats = render_hdr(scene, static, cam, cfg)
    if not bool(torch.isfinite(hdr).all()) or not bool(hdr.max() > hdr.min()):
        raise AssertionError("12a: NaN or constant image")
    _, kd_grad, _ = fwd_bwd(scene, static, cam, cfg)
    p11 = scene.blpatches.p11.detach().clone().requires_grad_(True)
    s = scene.replace(blpatches=scene.blpatches.replace(p11=p11))
    render_hdr(s, static, cam, cfg)[0].sum().backward()
    corner_grad = p11.grad
    peak = torch.cuda.max_memory_allocated(device) / 2**20
    launches = launches_since(wb, before)
    if min(launches["closest"], launches["any"]) < 1:
        raise AssertionError(f"12a: K1 or K2 not launched: {launches}")
    for name, g in (("kd", kd_grad), ("p11", corner_grad)):
        if not bool(torch.isfinite(g).all()) or not bool(g.abs().sum() > 0):
            raise AssertionError(f"12a: the {name} gradient is 0 or NaN")
    log(f"[12a patches] forward, fwd+bwd w.r.t. kd and w.r.t. the patches' "
        f"p11: peak device memory {peak:.1f} MiB; |grad p11| sum "
        f"{float(corner_grad.abs().sum()):.6g}; wide-tree launches "
        f"{launches}; card {card}")

    small = cfg.replace(width=PATCH_CPU_RES, height=PATCH_CPU_RES)
    with torch.no_grad():
        card_hdr = render_hdr(scene, static, cam, small)[0]
        cs, cst, ccam, _ = patch_scene(torch.device("cpu"))
        cpu_hdr = render_hdr(cs, cst, ccam, small)[0]
    bar, err = golden_or_exact(
        f"[12a patches] card vs CPU {PATCH_CPU_RES}x{PATCH_CPU_RES}",
        card_hdr.cpu(), cpu_hdr)
    return dict(patch_hits=n_patch, peak_mib=peak, launches=launches,
                cpu_bar=bar)


def phase_sharding(device, card):
    """12(b): render_hdr_sharded over local meshes of 1, 2 and 4 shards
    against render_hdr on lit sponza_proxy; train_step_sharded's step
    against the one-shard step; NCCL at world size 1."""
    import socket
    import torch
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    from cse168_raytracer_tpu_torch.parallel import distributed as dist
    from cse168_raytracer_tpu_torch.parallel.sharding import (
        make_mesh, render_hdr_sharded, train_step_sharded)
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    from cse168_raytracer_tpu_torch.scenes import build
    cfg = RenderConfig(width=RES, height=RES, trace_depth=DEPTH)
    scene, static, cam, cfg = build("sponza_proxy", cfg, device=device)
    scene = lit_sponza(attach_accel(scene))
    out = {"bars": {}}
    before = launch_counts(wb)
    with torch.no_grad():
        ref = render_hdr(scene, static, cam, cfg)[0]
        for n in (1, 2, 4):
            mesh = make_mesh(n, device)
            shd = render_hdr_sharded(scene, static, cam, cfg, mesh)
            out["bars"][n] = golden_or_exact(
                f"[12b sharding] {n} shard(s) vs render_hdr", shd, ref)[0]
    target = torch.full((RES, RES, 3), 0.05, device=device)
    steps = {n: train_step_sharded(scene, static, cam, cfg,
                                   make_mesh(n, device), target)
             for n in (1, 2, 4)}
    kd1 = steps[1][0].materials.kd
    errs = {n: float(((steps[n][0].materials.kd - kd1).abs()
                      / kd1.abs().clamp(min=1e-30)).max()) for n in (2, 4)}
    if not bool((kd1 != scene.materials.kd).any()):
        raise AssertionError("12b: the train step left kd unchanged")
    if max(errs.values()) > 1e-4:
        raise AssertionError(f"12b: sharded steps differ from the one-shard "
                             f"step: {errs}")
    # NCCL at world size 1: one sharded step through the process group
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_multihost(f"127.0.0.1:{port}", 1, 0, backend="nccl",
                        device=device)
    try:
        mesh = dist.global_mesh(1, device)
        if torch.distributed.get_backend(mesh.group) != "nccl":
            raise AssertionError("12b: the group is not NCCL")
        new, loss = train_step_sharded(scene, static, cam, cfg, mesh, target)
        img = dist.gather_image(render_hdr_sharded(scene, static, cam, cfg,
                                                   mesh), mesh)
    finally:
        dist.shutdown()
    nccl_err = float((new.materials.kd - kd1).abs().max())
    frame_ok = torch.allclose(torch.as_tensor(img), ref.cpu(), rtol=1e-5,
                              atol=1e-6)
    if nccl_err > 1e-6 or not frame_ok:
        raise AssertionError(f"12b: the NCCL step or frame differs "
                             f"(kd {nccl_err:.3g}, frame ok {frame_ok})")
    out["launches"] = launches_since(wb, before)
    out["kd_rel_err"] = errs
    log(f"[12b sharding] train_step_sharded over 1, 2 and 4 shards: new kd "
        f"vs one shard, max rel {errs}; NCCL (world size 1) kd max |diff| "
        f"{nccl_err:.3g}; wide-tree launches {out['launches']}; card {card}")
    return out


def phase_two_processes(device, card):
    """12(c): two processes of `cli render --sharded` on the one card
    (the command line joins them over gloo: NCCL refuses two ranks on a
    card) against the one-process 2-shard frame."""
    import socket
    import torch
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.parallel.sharding import (
        make_mesh, render_hdr_sharded)
    from cse168_raytracer_tpu_torch.render.tonemap import to_bytes, tonemap
    from cse168_raytracer_tpu_torch.scenes import build
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{i}.ppm") for i in range(2)]
        argv = [sys.executable, "-m", "cse168_raytracer_tpu_torch.cli",
                "render", "--scene", TWO_PROC_SCENE, "--width", str(RES),
                "--height", str(RES), "--depth", str(DEPTH), "--sharded",
                "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                "--bench", "--device", device.type]
        log(f"[12c two processes] {' '.join(argv[1:])} --process-id i")
        procs = [subprocess.Popen(argv + ["--process-id", str(i), "--out",
                                          outs[i]], cwd=root,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for i in range(2)]
        texts = []
        try:
            for p in procs:
                texts.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for i, (p, text) in enumerate(zip(procs, texts)):
            log("\n".join(f"  rank {i}: {ln}" for ln in text.splitlines()))
            if p.returncode != 0:
                raise AssertionError(f"12c: rank {i} exited {p.returncode}")
            if "2 processes over gloo" not in text:
                raise AssertionError(f"12c: rank {i} did not join over gloo")
        if os.path.exists(outs[1]):
            raise AssertionError("12c: rank 1 wrote an image")
        two = read_ppm(outs[0])
    cfg = RenderConfig(width=RES, height=RES, trace_depth=DEPTH)
    scene, static, cam, cfg = build(TWO_PROC_SCENE, cfg, device=device)
    with torch.no_grad():
        one = render_hdr_sharded(scene, static, cam, cfg,
                                 make_mesh(2, device))
    one = to_bytes(tonemap(one)).cpu().numpy()[::-1]     # the file's rows
    bad = int((two != one).any(-1).sum())
    log(f"[12c two processes] {TWO_PROC_SCENE} {RES}x{RES}, depth {DEPTH}: "
        f"2 processes x 1 shard over gloo on one card; the frame equals the "
        f"one-process 2-shard frame in {RES * RES - bad} of {RES * RES} "
        f"pixels; card {card}")
    if bad:
        raise AssertionError("12c: the two-process frame differs")


def phase_progressive(device, card):
    """12(d): `cli render --progressive --path-tracing --spp 16
    --checkpoint` on lit sponza_proxy, stopped at 8 samples and resumed,
    against the straight run; `cli view` at 256x256, 8 spp."""
    import io
    from cse168_raytracer_tpu_torch import cli
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    from cse168_raytracer_tpu_torch.scenes import build
    from cse168_raytracer_tpu_torch.config import RenderConfig
    scene, static, cam, _ = build("sponza_proxy", RenderConfig(
        width=RES, height=RES), device=device)
    built = (lit_sponza(attach_accel(scene)), static, cam)
    before = launch_counts(wb)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "state.npz")
        base = ["render", "--scene", "sponza_proxy", "--width", str(RES),
                "--height", str(RES), "--depth", str(DEPTH), "--progressive",
                "--path-tracing", "--no-accel", "--device", device.type]
        for label, extra in (("straight", ["--spp", str(SPP)]),
                             ("first 8", ["--spp", str(SPP // 2),
                                          "--checkpoint", ckpt]),
                             ("resumed", ["--spp", str(SPP), "--checkpoint",
                                          ckpt])):
            err = io.StringIO()
            argv = base + extra + ["--out", os.path.join(tmp, "p.png")]
            with contextlib.redirect_stderr(err):
                res[label] = cli.render(cli.parser().parse_args(argv),
                                        built=built)
            log(f"[12d progressive] {label}: {' '.join(argv[1:-2])}")
            log(err.getvalue().rstrip())
        if "resumed at 8/16" not in err.getvalue():
            raise AssertionError("12d: the second run did not resume")
        bar, _ = golden_or_exact("[12d progressive] resumed vs straight",
                                 res["resumed"]["hdr"], res["straight"]["hdr"])
        view_out = os.path.join(tmp, "preview.png")
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            view = cli.view(cli.parser().parse_args(
                ["view", "--scene", "sponza_proxy", "--width", str(VIEW_RES),
                 "--height", str(VIEW_RES), "--spp", str(VIEW_SPP),
                 "--device", device.type, "--out", view_out]))
        if not os.path.getsize(view_out) or view["hdr"].shape != (
                VIEW_RES, VIEW_RES, 3):
            raise AssertionError("12d: cli view wrote no preview")
    launches = launches_since(wb, before)
    log(f"[12d progressive] {RES}x{RES}, depth {DEPTH}, path-traced, "
        f"{SPP} spp: resumed = straight by {bar}; cli view "
        f"{VIEW_RES}x{VIEW_RES} {VIEW_SPP} spp; wide-tree launches "
        f"{launches}; card {card}")
    return dict(bar=bar, launches=launches)


def phase_viewer(device, card):
    """12(e): InteractiveViewer on lit sponza_proxy: preview and raytrace
    frames, after keys and a drag."""
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    from cse168_raytracer_tpu_torch.render.viewer import InteractiveViewer
    from cse168_raytracer_tpu_torch.scenes import build
    cfg = RenderConfig(width=RES, height=RES, trace_depth=DEPTH)
    scene, static, cam, cfg = build("sponza_proxy", cfg, device=device)
    v = InteractiveViewer(lit_sponza(attach_accel(scene)), static, cam, cfg)
    before = launch_counts(wb)
    frames = {"preview": 0, "raytrace": 0}
    for key in ("g", "w", "d", "drag", "+", "a", "r", "s", "drag", "g"):
        if key == "drag":
            v.handle_drag(12.0, -5.0)
        else:
            v.handle_key(key)
        mode = "raytrace" if v.state.raytrace else "preview"
        frame = v.render_frame()
        frames[mode] += 1
        if frame.shape != (RES, RES, 3) or not frame.any():
            raise AssertionError(f"12e: a blank {mode} frame")
    launches = launches_since(wb, before)
    log(f"[12e viewer] {RES}x{RES} lit sponza_proxy: {frames['preview']} "
        f"preview ({RES // 4}x{RES // 4}, depth 1, no shadows) and "
        f"{frames['raytrace']} raytrace (depth {DEPTH}) frames; wide-tree "
        f"launches {launches}; card {card}")
    return dict(launches=launches)


def phase_photon_sharded(device, card, unsharded):
    """12(f): build_photon_maps over a 2-shard mesh on photon_box against
    phase 11's unsharded build: stored photons per level per emitted one
    within tests/test_torch_photon.py's bar (3x the difference of two
    independent builds plus 3 sigma of one build's binomial noise), with
    the two-build difference at its standard deviation: 3 sigma_diff +
    3 sigma_one."""
    import torch
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    from cse168_raytracer_tpu_torch.ops.photon import build_photon_maps
    from cse168_raytracer_tpu_torch.parallel.sharding import make_mesh
    scene, static, _ = photon_scene(device)
    cfg = RenderConfig(**PHOTON_CFG)
    before = launch_counts(wb)
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    maps, stats = build_photon_maps(scene, static, cfg, gen,
                                    return_stats=True,
                                    mesh=make_mesh(2, device))
    launches = launches_since(wb, before)
    worst = 0.0
    for name in ("global", "caustic"):
        a, b = stats[name], unsharded[name]
        fa = np.asarray(a["stored_per_level"], np.float64) / a["emitted"]
        fb = np.asarray(b["stored_per_level"], np.float64) / b["emitted"]
        one = np.sqrt(fb * (1 - fb) / a["emitted"])
        diff = np.sqrt(fb * (1 - fb) / a["emitted"]
                       + fb * (1 - fb) / b["emitted"])
        z = np.abs(fa - fb) / np.maximum(3 * diff + 3 * one, 1e-12)
        worst = max(worst, float(z.max()))
        log(f"[12f photons] {name}: 2 shards emitted {a['emitted']}, stored "
            f"{a['stored']} {a['stored_per_level']}; unsharded emitted "
            f"{b['emitted']}, stored {b['stored']} {b['stored_per_level']}; "
            f"largest difference {float(z.max()):.3f} of the bar")
        grid = maps.global_map if name == "global" else maps.caustic_map
        if grid is None or grid.n_valid < PHOTONS:
            raise AssertionError(f"12f: the sharded {name} map is short")
    log(f"[12f photons] sharded build: wide-tree launches {launches}; card "
        f"{card}")
    if worst > 1.0:
        raise AssertionError("12f: sharded stored counts outside the bar")
    return dict(worst_of_bar=worst, launches=launches)


def phase_patches_and_parallel(device, card, photon_build_stats):
    """Phase 12 (a)-(f)."""
    out = dict(patches=phase_patches(device, card),
               sharding=phase_sharding(device, card))
    phase_two_processes(device, card)
    out.update(progressive=phase_progressive(device, card),
               viewer=phase_viewer(device, card),
               photons=phase_photon_sharded(device, card,
                                            photon_build_stats))
    out["launches"] = {k: sum(out[p]["launches"][k] for p in (
        "patches", "sharding", "progressive", "viewer", "photons"))
        for k in out["patches"]["launches"]}
    log(f"[12] wide-tree launches of phase 12: {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 13: the rounding census, the root on every input, card = CPU
# ---------------------------------------------------------------------------

CENSUS_N = 1 << 20        # inputs per op of the census
ROOT_CHUNK = 1 << 26      # bit patterns per chunk of the exhaustive root


def census_magnitudes(rng, n, top=1e6):
    """n float32 values in [0, top]: one in 16 a zero or a subnormal
    (random mantissas), the rest log-uniform over [2^-126, top]."""
    tiny = float(np.finfo(np.float32).tiny)
    x = np.exp(rng.uniform(np.log(tiny), np.log(top), n)).astype(np.float32)
    k = n // 16
    x[:k] = rng.integers(0, 1 << 23, k).astype(np.int32).view(np.float32)
    x[0] = 0.0
    rng.shuffle(x)
    return x


def census_cases(rng, n):
    """(name, float32 inputs, the port's torch op, the float64 reference)
    for every float32 elementwise op the port's renders use, over the
    ranges the renders feed it. The reference rounded once to float32 is
    the correctly rounded result for the root, the quotients and the
    products (53 >= 2 * 24 + 2 bits); for the transcendentals it is the
    float64 library's value rounded once, right but for double rounding."""
    import torch
    from cse168_raytracer_tpu_torch.core.vecmath import div_scalar, sqrt_rn
    mag = census_magnitudes(rng, n)
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    signed = mag * sign
    nonzero = census_magnitudes(rng, n)
    nonzero[nonzero == 0] = 1.0
    unit = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    angle = np.concatenate([rng.uniform(-2 * np.pi, 2 * np.pi, n // 2),
                            rng.uniform(-1e4, 1e4, n - n // 2)]
                           ).astype(np.float32)
    f32 = lambda c: np.float64(np.float32(c))
    cases = [
        ("torch.sqrt", (mag,), torch.sqrt, np.sqrt),
        ("sqrt in float64, rounded once", (mag,),
         lambda x: torch.sqrt(x.double()).float(), np.sqrt),
        ("vecmath.sqrt_rn", (mag,), sqrt_rn, np.sqrt),
        ("1.0 / x", (signed,), lambda x: 1.0 / x, lambda x: 1.0 / x),
        ("x / y (tensors)", (signed, nonzero), torch.div, np.divide),
    ]
    for label, c in (("3.0", 3.0), ("480.0", 480.0), ("2 pi", 2 * np.pi),
                     ("pi", np.pi)):
        cases += [
            (f"x / {label} (Python number)", (signed,),
             lambda x, c=c: x / c, lambda x, c=c: x / f32(c)),
            (f"vecmath.div_scalar(x, {label})", (signed,),
             lambda x, c=c: div_scalar(x, c),
             lambda x, c=c: x * np.float64(np.float32(1) / np.float32(c)))]
    cases += [
        ("torch.exp", (rng.uniform(-80, 80, n).astype(np.float32),),
         torch.exp, np.exp),
        ("torch.sin", (angle,), torch.sin, np.sin),
        ("torch.cos", (angle,), torch.cos, np.cos),
        ("torch.asin", (unit,), torch.asin, np.arcsin),
        ("torch.acos", (unit,), torch.acos, np.arccos),
        ("torch.atan2", (unit, rng.uniform(-1, 1, n).astype(np.float32)),
         torch.atan2, np.arctan2),
        ("torch.pow(x, 0.85)", (rng.uniform(0, 10, n).astype(np.float32),),
         lambda x: torch.pow(x, 0.85), lambda x: np.power(x, f32(0.85))),
        ("u ** (1 / (1 + s)) (tensor exponent)",
         (rng.uniform(1e-12, 1, n).astype(np.float32),
          (1.0 / (1.0 + rng.uniform(1, 1000, n))).astype(np.float32)),
         torch.pow, np.power),
    ]
    return cases


def bits_differ(a, b):
    """Elementwise: a and b (float32 tensors) differ in their bits, two
    NaNs counting as equal."""
    import torch
    nan = torch.isnan(a) & torch.isnan(b)
    return (a.view(torch.int32) != b.view(torch.int32)) & ~nan


def phase_census(device):
    """13(a): each op of census_cases on the card and on the CPU: how
    many results differ between them and how many each gets wrong
    against the correctly rounded reference."""
    import torch
    rng = np.random.default_rng(SEED)
    out = {}
    log(f"[13a census] {CENSUS_N} inputs an op: card != CPU; card wrong; "
        "CPU wrong (against float64 rounded once)")
    with np.errstate(all="ignore"):
        for name, xs, fn, ref in census_cases(rng, CENSUS_N):
            want = torch.from_numpy(np.asarray(
                ref(*(x.astype(np.float64) for x in xs))).astype(np.float32))
            cpu = fn(*(torch.from_numpy(x) for x in xs))
            card = fn(*(torch.from_numpy(x).to(device) for x in xs)).cpu()
            row = {k: int(bits_differ(a, b).sum()) for k, a, b in (
                ("card_vs_cpu", card, cpu), ("card_wrong", card, want),
                ("cpu_wrong", cpu, want))}
            out[name] = row
            log(f"  {name}: {row['card_vs_cpu']}; {row['card_wrong']}; "
                f"{row['cpu_wrong']}")
    for name in ("vecmath.sqrt_rn", "1.0 / x", "x / y (tensors)"):
        if any(out[name].values()):
            raise AssertionError(f"13a: {name} is not correctly rounded on "
                                 f"both devices: {out[name]}")
    for name in (k for k in out if k.startswith("vecmath.div_scalar")):
        if any(out[name].values()):
            raise AssertionError(f"13a: {name} differs: {out[name]}")
    return out


def root_rounded_to_nearest(x, r):
    """Elementwise: r is the float32 square root of x >= 0 rounded to
    nearest. For finite x > 0 that holds iff the float64 squares of the
    midpoints between r and its float32 neighbours bracket x; they are
    exact (25-bit midpoints), and no float32 x is such a square, so ties
    cannot occur."""
    import torch
    inf = torch.full_like(r, float("inf"))
    rd, xd = r.double(), x.double()
    lo = (rd + torch.nextafter(r, -inf).double()) / 2
    hi = (rd + torch.nextafter(r, inf).double()) / 2
    finite = (lo * lo <= xd) & (xd <= hi * hi) & (r > 0) & torch.isfinite(r)
    zero = (x == 0) & (r.view(torch.int32) == 0)
    return torch.where(x == 0, zero,
                       torch.where(torch.isinf(x), torch.isinf(r) & (r > 0),
                                   torch.where(torch.isnan(x),
                                               torch.isnan(r), finite)))


def exhaustive_root(fn, device, chunk=ROOT_CHUNK):
    """The number of the 2^31 non-negative float32 bit patterns (zero,
    subnormals, normals, +inf, NaNs) on which fn's root on `device` is
    not rounded to nearest, in chunks of `chunk` patterns."""
    import torch
    wrong = 0
    for start in range(0, 1 << 31, chunk):
        x = torch.arange(start, start + chunk, dtype=torch.int64,
                         device=device).to(torch.int32).view(torch.float32)
        wrong += int((~root_rounded_to_nearest(x, fn(x))).sum())
    return wrong


def phase_root(device):
    """13(b): sqrt_rn's root on all 2^31 non-negative float32 inputs, on
    the card (torch.sqrt) and on the CPU (numpy's)."""
    import torch
    from cse168_raytracer_tpu_torch.core.vecmath import sqrt_rn
    out = {}
    for name, fn, dev, chunk in (
            ("vecmath.sqrt_rn on the card", sqrt_rn, device, ROOT_CHUNK),
            ("vecmath.sqrt_rn on the CPU", sqrt_rn, torch.device("cpu"),
             ROOT_CHUNK // 4)):
        out[name] = exhaustive_root(fn, dev, chunk)
        log(f"[13b root] {name}: {out[name]} of 2^31 non-negative float32 "
            "inputs not rounded to nearest")
    if any(out.values()):
        raise AssertionError("13b: sqrt_rn is not correctly rounded")
    return out


def phase_scatter_order(device):
    """13(c): a level's accumulation with repeated pixels: the card's
    index_add, index_put_(accumulate=True) and the integrator's
    add_in_lane_order against the CPU's index_add (lane order), on terms
    of mixed magnitudes over a lit frame and on subnormal terms (a
    highlight's ipow(x, 500)) over a black one."""
    import torch
    from cse168_raytracer_tpu_torch.render.integrator import add_in_lane_order
    g = torch.Generator().manual_seed(SEED)
    n_pix = RES * RES
    # a depth-2 pool: up to four lanes a pixel, a fifth of them dead
    pixel = torch.randint(0, n_pix, (4 * n_pix,), generator=g)
    alive = torch.rand(4 * n_pix, generator=g) < 0.8
    mixed = torch.rand((4 * n_pix, 3), generator=g) * torch.exp(
        4 * torch.randn((4 * n_pix, 3), generator=g))
    subnormal = torch.randint(1, 1 << 21, (4 * n_pix, 3), generator=g,
                              dtype=torch.int32).view(torch.float32)
    out = {}
    for case, terms, base in (
            ("mixed terms", mixed, torch.rand((n_pix, 3), generator=g)),
            ("subnormal terms", subnormal, torch.zeros((n_pix, 3)))):
        contrib = torch.where(alive[:, None], terms, 0.0)
        want = base.index_add(0, pixel, contrib)
        b, p, c, a = (x.to(device) for x in (base, pixel, contrib, alive))
        got = {"index_add": b.index_add(0, p, c),
               "index_put_(accumulate=True)": b.index_put((p,), c,
                                                          accumulate=True),
               "add_in_lane_order": add_in_lane_order(b, p, c, a)}
        for name, v in got.items():
            v = v.cpu()
            out[(case, name)] = n = int(bits_differ(v, want).sum())
            log(f"[13c scatter] {case}: {name} on the card against the "
                f"CPU's index_add (lane order), {4 * n_pix} terms on "
                f"{n_pix} pixels: {n} of {want.numel()} values differ, "
                f"{int(((v == 0) & (want != 0)).sum())} of them 0 on the "
                "card")
        if out[(case, "add_in_lane_order")] or not torch.equal(
                add_in_lane_order(base, pixel, contrib, alive), want):
            raise AssertionError(f"13c ({case}): add_in_lane_order is not "
                                 "the lane-order sum")
    return out


BITEQ_RES = 512                 # 13(d)'s square renders
BITEQ_SPONZA_RES = 512          # lit sponza_proxy's
BITEQ_WIDE = (640, 480)         # test_sphere's, through the camera's divisions
TRANSCENDENTALS = ("exp", "sin", "cos", "tan", "asin", "acos", "arccos",
                   "atan2", "pow")


def bit_equal_cases():
    """(label, scene, width, height, depth, grad) of 13(d)'s Whitted
    renders; `grad`: 13(e) holds their kd gradients too (the forward of
    the fwd+bwd step is 13(d)'s render)."""
    r, s = BITEQ_RES, BITEQ_SPONZA_RES
    return ([(f"{name} depth {depth}", name, r, r, depth,
              name != "refract_spheres" or depth == DEPTH)
             for name in ("sphere", "mixed", "refract_spheres")
             for depth in (DEPTH, 10)]
            + [(f"lit sponza_proxy depth {DEPTH}", "sponza_proxy lit", s, s,
                DEPTH, True),
               (f"test_sphere depth {DEPTH}", "test_sphere", *BITEQ_WIDE,
                DEPTH, False)])


def bit_equal_scene(name, width, height, depth, device):
    """The scene of a bit_equal_cases() row on `device`, its accelerator
    attached, and its RenderConfig (Whitted, 1 spp)."""
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    from cse168_raytracer_tpu_torch.scenes import build
    cfg = RenderConfig(width=width, height=height, trace_depth=depth)
    if name == "mixed":
        scene, static, cam = mixed_scene(device)
    else:
        scene, static, cam, _ = build(name.split()[0], cfg, device=device)
        if name.endswith(" lit"):
            scene = lit_sponza(scene)
    return attach_accel(scene), static, cam, cfg


@contextlib.contextmanager
def transcendentals_on_host(keep=(), called=None):
    """Within: each torch function named in TRANSCENDENTALS but not in
    `keep`, and Tensor ** a non-integer, takes its CUDA arguments to the
    CPU, computes there and moves the result back, so a render takes the
    CPU's value for those ops and the card's for every other op. `called`
    (a set) collects the names called with a CUDA tensor."""
    import torch
    saved = {name: getattr(torch, name) for name in TRANSCENDENTALS}
    saved_pow = torch.Tensor.__pow__

    def on_host(name, fn):
        def run(*args, **kw):
            dev = next((a.device for a in args
                        if torch.is_tensor(a) and a.is_cuda), None)
            if dev is None:
                return fn(*args, **kw)
            if called is not None:
                called.add(name)
            if name in keep:
                return fn(*args, **kw)
            return fn(*(a.cpu() if torch.is_tensor(a) else a for a in args),
                      **kw).to(dev)
        return run

    pow_on_host = on_host("pow", saved_pow)
    try:
        for name, fn in saved.items():
            setattr(torch, name, on_host(name, fn))
        torch.Tensor.__pow__ = lambda x, e: (saved_pow(x, e)
                                             if isinstance(e, int)
                                             else pow_on_host(x, e))
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch, name, fn)
        torch.Tensor.__pow__ = saved_pow


# 13(d)'s allowance: the transcendentals that may round a scene's pixels
# differently on the card (measured by 13(d)'s attribution on an H100).
# PERF.md section 5's table "scene (phase 13) | transcendentals" shows the
# same rows; a scene absent here may differ through no op at all.
ROUNDED_BY_SCENE = {"refract_spheres": {"pow", "exp"}}
# 13(e)'s: the same for the kd gradient (autograd takes the backward of a
# transcendental on the device of its forward); PERF.md section 5 shows it
GRAD_ROUNDED_BY_SCENE = {"refract_spheres": {"exp"}}


def pixels_differ(a, b):
    """How many pixels of two (H, W, 3) float32 images differ in the bits
    of any channel."""
    return int(bits_differ(a.cpu(), b.cpu()).any(-1).sum())


def entries_differ(a, b):
    """How many entries of two float32 tensors differ in their bits."""
    return int(bits_differ(a.cpu(), b.cpu()).sum())


def bit_equal_run(name, w, h, depth, grad, device, ctx=None):
    """A bit_equal_cases() row on `device`: (hdr, kd gradient or None),
    fwd+bwd of sum(hdr) w.r.t. kd when `grad`; the render (not the
    scene's build) inside the context manager `ctx` if given."""
    import torch
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    scene, static, cam, cfg = bit_equal_scene(name, w, h, depth, device)
    with ctx or contextlib.nullcontext():
        if grad:
            hdr, kd_grad, _ = fwd_bwd(scene, static, cam, cfg)
        else:
            with torch.no_grad():
                hdr, kd_grad = render_hdr(scene, static, cam, cfg)[0], None
    return hdr.cpu(), None if kd_grad is None else kd_grad.cpu()


def attribute(label, want, run, allowed):
    """Where a card output differs from the CPU's `want` (a tuple of
    tensors): `run(**kw)` repeats the card's run inside
    transcendentals_on_host(**kw) and returns its outputs. With every
    transcendental on the CPU the outputs must be the CPU's; then each
    op the run called is left on the card alone, and the entries that
    differ with it are counted. Returns {op: [differing entries of each
    output]}; raises if an op outside `allowed` accounts for any, or no
    single op does."""
    called = set()
    rest = [entries_differ(a, b) for a, b in zip(run(called=called), want)
            if a is not None]
    if any(rest):
        raise AssertionError(f"{label}: {rest} entries still differ with "
                             "every transcendental on the CPU")
    ops = {}
    for op in sorted(called):
        k = [entries_differ(a, b) for a, b in zip(run(keep={op}), want)
             if a is not None]
        if any(k):
            ops[op] = k
    missing = set(ops) - allowed
    if missing or not ops:
        raise AssertionError(f"{label}: differences traced to "
                             f"{ops or 'no single op'}; the allowance names "
                             f"{sorted(allowed)}")
    return ops


def phase_bit_equal(device):
    """13(d), 13(e): each bit_equal_cases() row on the card and on the
    CPU, its Whitted forward (13(d)) and, for the rows that ask, its kd
    gradient (13(e), d sum(hdr) / d kd) held equal by torch.equal.
    Where an output differs, the card runs again with every
    transcendental on the CPU (which must give the CPU's outputs: no
    other op may round differently) and with each one it called left on
    the card alone, which names the ops the differences trace to;
    ROUNDED_BY_SCENE (the image) and GRAD_ROUNDED_BY_SCENE (the
    gradient) must name each of those for the scene."""
    import torch
    out = {}
    for label, name, w, h, depth, grad in bit_equal_cases():
        (card_hdr, card_g), (cpu_hdr, cpu_g) = (
            bit_equal_run(name, w, h, depth, grad, dev)
            for dev in (device, torch.device("cpu")))
        if not bool(torch.isfinite(cpu_hdr).all()) or not bool(
                cpu_hdr.max() > cpu_hdr.min()):
            raise AssertionError(f"13d {label}: NaN or constant image")
        n = pixels_differ(card_hdr, cpu_hdr)
        ng = None if not grad else entries_differ(card_g, cpu_g)
        row = {"size": (w, h), "differ": n, "grad_differ": ng, "ops": {},
               "grad_ops": {}}
        if grad and not (bool(torch.isfinite(cpu_g).all())
                         and bool(cpu_g.abs().sum() > 0)):
            raise AssertionError(f"13e {label}: NaN or zero kd gradient")
        if n or ng:
            scene_name = name.split()[0]

            def run(**kw):
                return bit_equal_run(name, w, h, depth, grad, device,
                                     transcendentals_on_host(**kw))
            ops = attribute(f"13d/e {label}", (cpu_hdr, cpu_g), run,
                            ROUNDED_BY_SCENE.get(scene_name, set())
                            | GRAD_ROUNDED_BY_SCENE.get(scene_name, set()))
            row["ops"] = {op: k[0] for op, k in ops.items() if k[0]}
            row["grad_ops"] = {op: k[1] for op, k in ops.items()
                               if len(k) > 1 and k[1]}
            for what, counts, allowed in (
                    ("pixels", row["ops"], ROUNDED_BY_SCENE),
                    ("gradient entries", row["grad_ops"],
                     GRAD_ROUNDED_BY_SCENE)):
                extra = set(counts) - allowed.get(scene_name, set())
                if extra:
                    raise AssertionError(
                        f"13d/e {label}: {what} differ through {extra}, "
                        f"which the allowance for {scene_name} does not "
                        "name")
        out[label] = row
        ops = ", ".join(f"{k} {v}" for k, v in row["ops"].items())
        log(f"[13d card = CPU] {label} {w}x{h}: "
            + ("torch.equal holds" if not n else
               f"{n} of {w * h} pixels differ, with the card's "
               f"transcendentals alone ({ops} pixels with that op alone on "
               "the card; 0 with all on the CPU)")
            + (" (fwd+bwd)" if grad else ""))
        if grad:
            gops = ", ".join(f"{k} {v}" for k, v in row["grad_ops"].items())
            rel = float((card_g - cpu_g).abs().max()
                        / cpu_g.abs().max().clamp(min=1e-30))
            log(f"[13e kd gradient card = CPU] {label} {w}x{h}: "
                + ("torch.equal holds" if not ng else
                   f"{ng} of {cpu_g.numel()} entries differ (max |diff| / "
                   f"max {rel:.3g}), with the card's transcendentals alone "
                   f"({gops} entries with that op alone on the card; 0 with "
                   "all on the CPU)"))
    return out


def count_differ(a, b):
    """Entries of two tensors that differ: float32 ones in their bits
    (two NaNs equal), others by value."""
    import torch
    a, b = a.cpu(), b.cpu()
    if a.dtype == b.dtype == torch.float32:
        return int(bits_differ(a, b).sum())
    return int((a != b).sum())


def photon_power_grads(scene, static, cam, cfg, maps):
    """(hdr, the gradients of sum(hdr) w.r.t. the stored powers of both
    maps, fine and coarse levels): the photon-power gradient of
    gain_step before its reduction to the three gains."""
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    leaves, grids = [], {}
    for name in ("global_map", "caustic_map"):
        g = getattr(maps, name)
        fine = g.power.detach().clone().requires_grad_(True)
        coarse = g.coarse.power.detach().clone().requires_grad_(True)
        leaves += [fine, coarse]
        grids[name] = g.replace(power=fine,
                                coarse=g.coarse.replace(power=coarse))
    hdr, _ = render_hdr(scene.replace(photons=maps.replace(**grids)), static,
                        cam, cfg)
    hdr.sum().backward()
    return (hdr.detach(),) + tuple(t.grad for t in leaves)


# 13(f)'s allowance: transcendentals that may round photon_box's photon
# render or its photon-power gradient differently on the card
PHOTON_ROUNDED = set()
PHOTON_GRAD_CHUNK = 1 << 21   # 13(f)'s twin forward, its chunk budget


def phase_photon_bits(device, card, photons):
    """13(f): the photon path, card = CPU. (i) trace_photon_batch on
    phase 11(c)'s uniforms with the transcendentals on the CPU: the
    stored photons (positions, directions, powers, masks, bounce counts)
    equal the CPU's by torch.equal; (ii) phase 11(e)'s render at
    PHOTON_CPU_RES, depth 10, with the same maps: torch.equal, or every
    differing pixel traced to a transcendental PHOTON_ROUNDED names;
    (iii) the photon-power gradient of that render (both maps, both
    levels): the same; (iv) that gradient on the card at PHOTON_RES
    after the gather kernel's forward and after its plain twin's:
    torch.equal. Returns the largest photon
    backward segment_sum call of (iv), for 13(g)."""
    import torch
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.ops import photon as ph
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    cpu = torch.device("cpu")
    scene, static, cam = photon_scene(device)
    maps_cpu = photons["maps_cpu"]
    maps = maps_cpu.to(device)
    out = {}
    for name, tr in photons["trace"].items():
        u = tr["uniforms"]
        u_card = ph.PhotonUniforms(**{
            f.name: None if getattr(u, f.name) is None
            else getattr(u, f.name).to(device) for f in dataclasses.fields(u)})
        fields = ("pos", "dir", "power", "mask", "bounces")

        def trace(**kw):
            with transcendentals_on_host(**kw):
                b = ph.trace_photon_batch(scene, static, 0, name == "caustic",
                                          False, u_card)
            return [getattr(b, f).cpu() for f in fields]
        want = [getattr(tr["cpu_batch"], f) for f in fields]
        own = {f: count_differ(a, b) for f, a, b in zip(fields, trace(keep=(
            *TRANSCENDENTALS,)), want)}
        host = {f: count_differ(a, b) for f, a, b in zip(fields, trace(),
                                                         want)}
        out[f"trace {name}"] = dict(card=own, host=host)
        log(f"[13f photons card = CPU] trace_photon_batch, {name}, "
            f"{PHOTON_TRACE_N} photons x 6 levels on 11(c)'s uniforms: with "
            f"the transcendentals on the CPU {host} entries differ; with "
            f"the card's own {own}")
        if any(host.values()):
            raise AssertionError(f"13f: {name} photons differ with the "
                                 "transcendentals on the CPU")
    small = RenderConfig(width=PHOTON_CPU_RES, height=PHOTON_CPU_RES,
                         trace_depth=10)
    card_hdr, cpu_hdr = (photons["match"][k] for k in ("card_hdr",
                                                       "cpu_hdr"))
    n = pixels_differ(card_hdr, cpu_hdr)
    row = {"differ": n, "ops": {}}
    if n:
        def render(**kw):
            with torch.no_grad(), transcendentals_on_host(**kw):
                return (render_hdr(scene.replace(photons=maps), static, cam,
                                   small)[0].cpu(),)
        row["ops"] = {op: k[0] for op, k in attribute(
            "13f render", (cpu_hdr,), render, PHOTON_ROUNDED).items()}
    out["render"] = row
    log(f"[13f photons card = CPU] 11(e)'s render {PHOTON_CPU_RES}x"
        f"{PHOTON_CPU_RES}, depth 10, the same maps: "
        + ("torch.equal holds" if not n else
           f"{n} pixels differ, traced to {row['ops']}"))
    cpu_scene, cpu_static, cpu_cam = photon_scene(cpu)
    want = photon_power_grads(cpu_scene, cpu_static, cpu_cam, small,
                              maps_cpu)
    got = [x.cpu() for x in photon_power_grads(scene, static, cam, small,
                                               maps)]
    labels = ("image", "global fine", "global coarse", "caustic fine",
              "caustic coarse")
    diff = {k: count_differ(a, b) for k, a, b in zip(labels, got, want)}
    if not sum(float(g.abs().sum()) for g in want[1:]) > 0:
        raise AssertionError("13f: a zero photon-power gradient")
    row = {"differ": diff, "ops": {}}
    if any(diff.values()):
        def grads(**kw):
            with transcendentals_on_host(**kw):
                return tuple(x.cpu() for x in photon_power_grads(
                    scene, static, cam, small, maps))
        row["ops"] = attribute("13f photon-power gradient", tuple(want),
                               grads, PHOTON_ROUNDED)
    out["grad"] = row
    log(f"[13f photons card = CPU] the photon-power gradient of that "
        f"render: entries differing {diff}"
        + (f", traced to {row['ops']}" if row["ops"] else
           ": torch.equal holds"))
    # (iv) at PHOTON_RES on the card, after the kernel's forward and
    # after the plain twin's; keep the largest photon backward
    # segment_sum call for 13(g)
    from cse168_raytracer_tpu_torch.ops import photon_gather as pg
    big = RenderConfig(width=PHOTON_RES, height=PHOTON_RES, trace_depth=10)
    first = []
    level = record_segment_sum(ph, lambda: first.extend(
        photon_power_grads(scene, static, cam, big, maps)))
    chunk = PHOTON_GRAD_CHUNK // (27 * maps.global_map.max_per_cell)
    kernel = pg.gather
    pg.gather = lambda grid, p, n, power, coarse_power: ph.gather_levels(
        grid, p, n, power, coarse_power, chunk)
    try:
        second = photon_power_grads(scene, static, cam, big, maps)
    finally:
        pg.gather = kernel
    diff = {k: count_differ(a, b) for k, a, b in zip(labels, first, second)}
    out["twin"] = diff
    log(f"[13f photons] the photon-power gradient at {PHOTON_RES}x"
        f"{PHOTON_RES}, depth 10, after the kernel's forward and after the "
        f"plain twin's ({chunk} points a chunk; backward chunk "
        f"{ph.backward_chunk(maps.global_map)}): entries differing {diff}; "
        f"card {card}")
    if any(diff.values()):
        raise AssertionError("13f: the photon-power gradient differs "
                             "between the kernel's forward and the twin's")
    return out, level


def record_segment_sum(module, fn):
    """fn() with module.segment_sum recording its calls: returns
    (values, ids, n_rows) of the first call with the most terms."""
    real, seen = module.segment_sum, []

    def keep(values, ids, n_rows):
        if not seen or values.shape[0] > seen[0][0].shape[0]:
            seen[:] = [(values.clone(), ids.clone(), n_rows)]
        return real(values, ids, n_rows)
    module.segment_sum = keep
    try:
        fn()
    finally:
        module.segment_sum = real
    return seen[0]


SEGSUM_BIG_RUN = 1 << 21
SEGSUM_WIDE_ROWS = (1 << 19) + 1     # 20 key bits
SEGSUM_WIDE_TERMS = 1 << 18


def segsum_synthetic(device, seed=SEED):
    """13(g)'s shapes made from a seed: a run of SEGSUM_BIG_RUN terms;
    SEGSUM_WIDE_TERMS x 29 terms on SEGSUM_WIDE_ROWS rows (random ids);
    runs of 1-64 terms, 262,144 x 3, their lanes shuffled."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    out = {f"one run of {SEGSUM_BIG_RUN}": (
        torch.randn((SEGSUM_BIG_RUN, 1), generator=g, device=device),
        torch.zeros(SEGSUM_BIG_RUN, dtype=torch.int64, device=device), 1)}
    out["random ids, 20 bits, 29 columns"] = (
        torch.randn((SEGSUM_WIDE_TERMS, 29), generator=g, device=device),
        torch.randint(0, SEGSUM_WIDE_ROWS, (SEGSUM_WIDE_TERMS,), generator=g,
                      device=device), SEGSUM_WIDE_ROWS)
    n = 1 << 18
    lens = torch.randint(1, 65, (n // 32,), generator=g, device=device)
    ids = torch.repeat_interleave(torch.arange(lens.numel(), device=device),
                                  lens)[:n]
    ids = ids[torch.randperm(ids.numel(), generator=g, device=device)]
    out["runs of 1-64"] = (torch.randn((ids.numel(), 3), generator=g,
                                       device=device), ids, lens.numel())
    return out


def phase_segment_sum(device, card, main_run, photon_level):
    """13(g): the segment-sum kernel against segment_sum_plain on the
    card, torch.equal, and against itself over two runs, at the shapes
    the paths give it: the main step's kd backward (recorded from a lit
    step), the same terms in a single run of all, ReattachRows' backward
    of a lit step w.r.t. the triangles' v0 (recorded), 13(f)'s largest
    photon backward call, and segsum_synthetic's (a run of
    SEGSUM_BIG_RUN: more than 1,024 tiles; random ids on 2^19 + 1 rows at
    29 columns; runs of 1-64). Where there is more than one row the
    kernel's sort equals torch.sort(stable=True)'s permutation and runs
    once a call; with one row it runs no sort."""
    import torch
    from cse168_raytracer_tpu_torch.core import fastgather
    from cse168_raytracer_tpu_torch.ops import segment_sum as ss
    from cse168_raytracer_tpu_torch.ops import surface
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    lit = lit_sponza(main_run["scene"])
    static, cam = main_run["static"], main_run["cam"]
    cfg = RenderConfig(width=RES, height=RES, trace_depth=DEPTH)
    kd = record_segment_sum(fastgather,
                            lambda: fwd_bwd(lit, static, cam, cfg))

    def v0_step():
        v0 = lit.tris.v0.detach().clone().requires_grad_(True)
        s = lit.replace(tris=lit.tris.replace(v0=v0))
        render_hdr(s, static, cam, cfg)[0].sum().backward()
    tri = record_segment_sum(surface, v0_step)
    shapes = {
        "kd backward (main step)": kd,
        "kd backward, one run of all": (kd[0], torch.zeros_like(kd[1]),
                                        kd[2]),
        "ReattachRows backward (v0)": tri,
        "photon backward (13(f))": photon_level,
        **segsum_synthetic(device)}
    out = {}
    for label, (v, ids, n_rows) in shapes.items():
        v, ids = v.contiguous(), ids.long().contiguous()
        want = ss.segment_sum_plain(v, ids, n_rows)
        sorts = launch_counts(ss)["sort"]
        a = ss.segment_sum(v, ids, n_rows)
        b = ss.segment_sum(v, ids, n_rows)
        sorted_ = launch_counts(ss)["sort"] - sorts
        torch.cuda.synchronize()
        same, again = torch.equal(a, want), torch.equal(a, b)
        order = (torch.equal(ss.stable_order(ids, n_rows).long(),
                             torch.sort(ids, stable=True)[1])
                 if n_rows > 1 else None)
        err = float((a - want).abs().max())
        n, cols = v.shape
        runs = torch.bincount(ids, minlength=n_rows)
        row = dict(terms=n, cols=cols, rows=n_rows, longest=int(runs.max()),
                   empty=int((runs == 0).sum()), equal=same, repeat=again,
                   sort_equal=order, max_abs_err=err)
        out[label] = row
        log(f"[13g segment_sum] {label}: {n} x {cols} terms on {n_rows} "
            f"rows (longest run {row['longest']}, {row['empty']} empty): "
            f"kernel = plain by torch.equal {same}, run twice equal "
            f"{again}, sort = torch.sort {order}, sorts launched "
            f"{sorted_} in two calls, max |err| {err:.3g}; card {card}")
        if not (same and again and order in (True, None)):
            raise AssertionError(f"13g {label}: the kernel differs from its "
                                 "plain version or from itself, or its sort "
                                 "from torch.sort")
        if sorted_ != (2 if n_rows > 1 else 0):
            raise AssertionError(f"13g {label}: {sorted_} sorts in two calls "
                                 f"on {n_rows} rows")
    return out


def phase_rounding(device, card, main_run, photons):
    """Phase 13: (a) the census, (b) the root on every input, (c) the
    accumulation's order, (d) card = CPU at full size, (e) kd gradients
    card = CPU, (f) the photon path card = CPU, (g) the segment-sum
    kernel against its plain version at the paths' shapes."""
    out = {"census": phase_census(device), "root": phase_root(device),
           "scatter": phase_scatter_order(device),
           "renders": phase_bit_equal(device)}
    out["photons"], level = phase_photon_bits(device, card, photons)
    out["segment_sum"] = phase_segment_sum(device, card, main_run, level)
    return out


# ---------------------------------------------------------------------------
# the kernel timer of the package's microbenchmarks (profile_kinds,
# profile_segsum); no phase above calls them
# ---------------------------------------------------------------------------

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


def device_ops(fn):
    """The device operations (kernels, memsets, copies) of one fn() call,
    by torch.profiler: a list of (name, device us), namespaces, templates
    and arguments cut from the names. A trace that caught no device
    operation (seen now and then on the card) is taken again, up to three
    times; None if every one came back empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    ops = []
    for e in events:
        name = e.name.replace("(anonymous namespace)::", "")
        if not name.startswith(("Memset", "Memcpy")):
            name = name.removeprefix("void ").split("<")[0].split("(")[0]
        ops.append((name.split("::")[-1], e.time_range.elapsed_us()))
    return ops or None


def main():
    device, card = phase_device()
    ptxas = phase_build()
    errs = {"closest": 0.0, "any": 0.0, "stats": 0.0}
    k3_cases, sponza_rays = phase_kernel_vs_oracle(device)
    # phase 7 runs on phase 3's trees while they are on the card; they
    # are freed before phase 4 measures the step's peak memory
    phase_k3(k3_cases, errs)
    del k3_cases
    main_run = phase_main_path(device)
    phase_card_vs_cpu(device)
    phase_children_on_card(device)
    phase_plain(device, main_run, errs)
    cli_launches = phase_cli(device, card)
    steps, k5, k5_stats_launches, k4 = phase_kinds(device, sponza_rays)
    textured = phase_textured(device, card)
    photons = phase_photons(device, card)
    rest = phase_patches_and_parallel(device, card, photons["build"]["stats"])
    rounding = phase_rounding(device, card, main_run, photons)
    import torch
    src = "cse168_raytracer_tpu_torch/csrc/traverse_wide.cu"
    src5 = "cse168_raytracer_tpu_torch/csrc/traverse_binary.cu"
    replaces = "cse168_raytracer_tpu/ops/pallas_bvh.py:1056"

    def regs(*names, prefix="traverse_warp "):
        """Registers and spilled bytes of the named kernels."""
        ks = [ptxas[prefix + x] for x in names]
        return {"registers": [k["registers"] for k in ks],
                "spill_bytes": [k["spill_stores"] + k["spill_loads"]
                                for k in ks]}
    sah_launches = steps["pallas_sah step"]["launches"]
    kernels = [
        {"name": "traverse_wide closest+attr (W=4)", "route": "cuda",
         "source": src, "replaces": replaces,
         "launches": (main_run["launches"]["closest"]
                      + textured["launches"]["closest"]
                      + photons["launches"]["closest"]
                      + rest["launches"]["closest"]),
         "max_abs_err": errs["closest"], **regs("W=4 closest")},
        {"name": "traverse_wide any-hit (W=4)", "route": "cuda",
         "source": src, "replaces": replaces,
         "launches": (main_run["launches"]["any"]
                      + textured["launches"]["any"]
                      + photons["launches"]["any"]
                      + rest["launches"]["any"]),
         "max_abs_err": errs["any"], **regs("W=4 any")},
        {"name": "traverse_wide with counters, closest+attr and any-hit "
                 "(K3)", "route": "cuda", "source": src,
         "replaces": "cse168_raytracer_tpu/ops/pallas_bvh.py:1020",
         "launches": (cli_launches["stats_closest"]
                      + cli_launches["stats_any"]
                      + photons["launches"]["stats_closest"]
                      + photons["launches"]["stats_any"]),
         "max_abs_err": errs["stats"],
         **regs("W=4 closest stats", "W=4 any stats")},
        {"name": "traverse_wide W=8 tree (K4)", "route": "cuda",
         "source": src,
         "replaces": "cse168_raytracer_tpu/ops/pallas_bvh.py:1331",
         "launches": k4["launches"], "max_abs_err": k4["err"],
         **regs("W=8 closest", "W=8 any")},
        {"name": "traverse_binary closest (K5)", "route": "cuda",
         "source": src5,
         "replaces": "cse168_raytracer_tpu/ops/pallas_bvh.py:276",
         "launches": sah_launches["closest"],
         "max_abs_err": k5["errs"]["closest"],
         **regs("closest", prefix="traverse_binary_warp ")},
        {"name": "traverse_binary any-hit (K5)", "route": "cuda",
         "source": src5,
         "replaces": "cse168_raytracer_tpu/ops/pallas_bvh.py:276",
         "launches": sah_launches["any"],
         "max_abs_err": k5["errs"]["any"],
         **regs("any", prefix="traverse_binary_warp ")},
        {"name": "traverse_binary with counters, closest and any-hit (K5)",
         "route": "cuda", "source": src5,
         "replaces": "cse168_raytracer_tpu/ops/pallas_bvh.py:254",
         "launches": (k5_stats_launches["stats_closest"]
                      + k5_stats_launches["stats_any"]),
         "max_abs_err": k5["errs"]["stats"],
         **regs("closest stats", "any stats",
                prefix="traverse_binary_warp ")},
        # compare_k6 raises unless t and id equal the plain version's
        {"name": "tri_blocks closest (K6)", "route": "cuda",
         "source": "cse168_raytracer_tpu_torch/csrc/tri_blocks.cu",
         "replaces": "cse168_raytracer_tpu/ops/pallas_intersect.py:105",
         "launches": steps["pallas step"]["launches"]["closest"],
         "max_abs_err": 0.0,
         **regs("tri_blocks_cull", "tri_blocks_test", "tri_blocks_finish",
                prefix="")},
        {"name": "segment_sum, fixed-order segmented sum (the gradient "
                 "scatters)", "route": "cuda",
         "source": "cse168_raytracer_tpu_torch/csrc/segment_sum.cu",
         "replaces": "no TPU kernel: the transpose of "
                     "cse168_raytracer_tpu/core/fastgather.py:38 take_rows "
                     "(XLA's), a kernel of the port alone",
         "launches": main_run["launches"]["segment_sum"],
         "max_abs_err": max(r["max_abs_err"]
                            for r in rounding["segment_sum"].values()),
         **regs(*SEGSUM_KERNELS, prefix="")},
        {"name": "photon_gather, the hashed-grid k-NN irradiance gather "
                 "of both levels", "route": "cuda",
         "source": "cse168_raytracer_tpu_torch/csrc/photon_gather.cu",
         "replaces": "no TPU kernel: cse168_raytracer_tpu/ops/photon.py:241 "
                     "_gather_level (XLA's), a kernel of the port alone",
         "launches": photons["render"]["gather_launches"],
         "max_abs_err": photons["kernel"]["max_abs_err"],
         **regs(*PHOTON_GATHER_KERNELS, prefix="")},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
