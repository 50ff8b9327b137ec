"""Command-line entry point of the port (counterpart of
cse168_raytracer_tpu/cli.py: main.cpp's headless path, pick a scene,
render, write the image; and the viewer commands).

Usage:
    python -m cse168_raytracer_tpu_torch.cli render --scene sponza_proxy \
        --width 512 --height 512 --depth 4 --stats --out out.png
    python -m cse168_raytracer_tpu_torch.cli render --scene test_sphere \
        --path-tracing --spp 16 --depth 4 --out test_sphere.png
    python -m cse168_raytracer_tpu_torch.cli render --scene sphere \
        --device cpu --width 64 --height 64 --out sphere.ppm
    python -m cse168_raytracer_tpu_torch.cli render --scene photon_cornell \
        --photons 200000 --caustic-photons 200000 --stats \
        --visualize-photons photons.png --out cornell.png
    python -m cse168_raytracer_tpu_torch.cli render --scene sphere --sharded \
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 0 ...
    python -m cse168_raytracer_tpu_torch.cli render --scene sphere \
        --progressive --path-tracing --spp 64 --checkpoint state.npz
    python -m cse168_raytracer_tpu_torch.cli view --scene sphere
    python -m cse168_raytracer_tpu_torch.cli window --scene sphere
    python -m cse168_raytracer_tpu_torch.cli scenes      # list scenes

It renders on the card (--device cuda, the default) unless --device cpu
is given, and never falls back to the CPU; a process of a multi-process
job given plain `cuda` takes card rank % cards. The render is timed
twice, its first run and then a second, steady-state run of the same
seed. It prints [scene], [accel], [render], [stats] and [out] lines on
stderr, as the JAX package's command line does; --stats adds the ray
counts and the traversal's in-kernel counters, which in the port are
each ray's own walk (the JAX package bills a tile's visits to each of
its rays). --photons N builds the photon maps first (N global photons
per directional-area light, --caustic-photons M caustic ones; the
generator is seeded with --seed + 7) and prints a [photons] line, and
with --stats or --visualize-photons each map's emitted, stored and
bounce counts; --visualize-photons PATH writes the stored photons over
the frame (global green, caustic red); --no-photon-map renders without
the maps.

--sharded renders the rows over a mesh (parallel/sharding.py) of one
shard a process, once (and a second, steady-state time with --bench),
and process 0 writes the gathered frame; --coordinator host:port,
--num-processes and --process-id join a torch.distributed job first,
which renders sharded too. The backend is gloo on the CPU, and on the
card NCCL, unless the coordinator is this machine (a loopback address)
and the job has more processes than it has cards: NCCL refuses two
ranks on one card, so those ranks share theirs over gloo. The height
must divide over the shards (else exit 2).
--progressive renders --spp samples one pass at a time
(render/progressive.py), saving its state to --checkpoint every
--checkpoint-every samples and resuming from it. `view` renders
progressively and rewrites --out after every sample; `window` opens
the interactive viewer (render/viewer.py; needs matplotlib).
"""

from __future__ import annotations

import argparse
import sys
import time


def _log(*args):
    print(*args, file=sys.stderr, flush=True)


def _cmd_scenes(_args) -> int:
    from cse168_raytracer_tpu_torch.scenes import SCENES
    for name in sorted(SCENES):
        print(name)
    return 0


def _device(args):
    """args.device as a torch.device; plain `cuda` in a process of a
    multi-process job is card process_id % cards."""
    import torch

    from cse168_raytracer_tpu_torch.config import resolve_device
    device = resolve_device(args.device)
    pid = getattr(args, "process_id", None)
    if device.type == "cuda" and device.index is None and pid is not None:
        device = torch.device("cuda", pid % torch.cuda.device_count())
    return device


def _sync(device):
    import torch
    return (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" \
        else (lambda: None)


def _backend(args, device):
    """gloo where ranks of this machine would share a card (see the
    module's docstring); None (init_multihost's default) elsewhere."""
    import ipaddress

    import torch
    if device.type != "cuda" or args.coordinator is None:
        return None
    host = args.coordinator.rsplit(":", 1)[0].strip("[]")
    try:
        local = host == "localhost" or ipaddress.ip_address(host).is_loopback
    except ValueError:          # a host name: not resolved here
        local = False
    shared = local and (args.num_processes or 1) > torch.cuda.device_count()
    return "gloo" if shared else None


def render(args, built=None) -> dict:
    """The `render` command on parsed arguments: join the process group
    when asked, build args.scene (or take `built`, that scene's (Scene,
    SceneStatic, Camera) as scenes.build gives them), build its photon
    maps when asked, render it (sharded, progressively, or twice), write
    args.out (and the photon overlay). Returns the exit status `rc`, the
    HDR image, the RenderStats (None for sharded and progressive
    renders), the timings and the photon counts."""
    import torch.distributed as tdist

    from cse168_raytracer_tpu_torch.parallel import distributed as dist
    device = _device(args)
    joined = not tdist.is_initialized()
    rank = dist.init_multihost(args.coordinator, args.num_processes,
                               args.process_id, backend=_backend(args, device),
                               device=device)
    try:
        return _render(args, built, device, rank)
    finally:
        if joined:
            dist.shutdown()


def _render(args, built, device, rank) -> dict:
    import torch
    import torch.distributed as tdist

    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.parallel import distributed as dist
    from cse168_raytracer_tpu_torch.render.image_io import write_image
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    from cse168_raytracer_tpu_torch.render.tonemap import to_bytes, tonemap
    from cse168_raytracer_tpu_torch.scenes.registry import build

    sync = _sync(device)
    cfg = RenderConfig(
        width=args.width, height=args.height, trace_depth=args.depth,
        trace_samples=args.spp, path_tracing=args.path_tracing,
        dof=args.dof, disable_shadows=args.no_shadows,
        light_samples=args.light_samples, row_tile=args.row_tile,
        photons_per_light=args.photons,
        caustic_photons_per_light=args.caustic_photons,
        collect_stats=args.stats, seed=args.seed)
    mesh = None
    if args.sharded or tdist.is_initialized():
        mesh = dist.global_mesh(1, device)
        group = (f"{tdist.get_world_size()} processes over "
                 f"{tdist.get_backend()}" if tdist.is_initialized()
                 else "one process")
        _log(f"[mesh] {mesh.size} shard(s), {group}; this is rank {rank} "
             f"on {device}")
        if cfg.height % mesh.size:
            _log(f"error: --height {cfg.height} must be divisible by the "
                 f"device count ({mesh.size}) for row sharding")
            return dict(rc=2)

    t0 = time.perf_counter()
    if built is None:
        scene, static, cam, cfg = build(args.scene, cfg, device=device)
    else:
        scene, static, cam = built
    _log(f"[scene] {'given' if built else 'built'} {args.scene} on {device} "
         f"in {time.perf_counter() - t0:.2f}s ({scene.tris.num_tris} padded "
         f"tris)")
    if args.accel:
        from cse168_raytracer_tpu_torch.ops.accel import attach_accel
        t0 = time.perf_counter()
        scene = attach_accel(scene)
        sync()
        tree = ("no triangles, no tree" if scene.accel is None else
                f"W={scene.accel.width}, {scene.accel.n_nodes} nodes, "
                f"{scene.accel.n_leaves} leaves")
        _log(f"[accel] built in {time.perf_counter() - t0:.2f}s ({tree})")
    photon_stats = {}
    if cfg.photons_per_light > 0 and not args.no_photon_map:
        from cse168_raytracer_tpu_torch.ops.photon import build_photon_maps
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(cfg.seed + 7)
        photons, photon_stats = build_photon_maps(scene, static, cfg, gen,
                                                  return_stats=True)
        scene = scene.replace(photons=photons)
        sync()
        _log(f"[photons] traced in {time.perf_counter() - t0:.2f}s")
        if args.stats or args.visualize_photons:
            for name, st in photon_stats.items():
                lvl = st.get("stored_per_level")
                lvl_s = (" per-level=" + "/".join(map(str, lvl))
                         if lvl else "")
                _log(f"[stats] photons {name}: emitted={st['emitted']} "
                     f"stored={st['stored']} bounces={st['bounces']}"
                     f"{lvl_s}")

    res = dict(rc=0, stats=None, steady_s=None, device=device,
               photons=scene.photons, photon_stats=photon_stats, rank=rank,
               samples=(cfg.trace_samples if (cfg.path_tracing or cfg.dof
                                              or args.progressive) else 1))
    if mesh is not None:
        return _render_sharded(args, scene, static, cam, cfg, mesh, sync,
                               res)
    if args.progressive:
        from cse168_raytracer_tpu_torch.render.progressive import \
            render_progressive
        t0 = time.perf_counter()
        hdr = render_progressive(scene, static, cam, cfg, cfg.seed,
                                 checkpoint_path=args.checkpoint,
                                 checkpoint_every=args.checkpoint_every)
        sync()
        res["first_s"] = time.perf_counter() - t0
        _log(f"[render] progressive {cfg.trace_samples} spp in "
             f"{res['first_s']:.2f}s")
    else:
        times = []
        with torch.no_grad():
            for _ in range(2):
                t0 = time.perf_counter()
                hdr, stats = render_hdr(scene, static, cam, cfg)
                sync()
                times.append(time.perf_counter() - t0)
        n_rays = (int(stats.primary_rays) + int(stats.secondary_rays)
                  + int(stats.shadow_rays))
        samples = res["samples"]
        _log(f"[render] first run {times[0]:.3f}s, steady-state "
             f"{times[1]:.4f}s ({times[1] * 1e3 / samples:.3f} ms/sample, "
             f"{samples} spp); {n_rays} rays, {n_rays / times[1]:.1f} rays/s")
        res.update(stats=stats, first_s=times[0], steady_s=times[1],
                   rays=n_rays)
        if args.stats:
            _stats_lines(scene, stats, n_rays)
    res["hdr"] = hdr
    img = to_bytes(tonemap(hdr, args.tonemap)).cpu().numpy()
    write_image(args.out, img)
    _log(f"[out] wrote {args.out}")
    if args.visualize_photons:
        # Scene.cpp:405-409,586-591: the stored photons over the frame
        if scene.photons is None:
            _log("[viz] no photon maps built (use --photons N)")
        else:
            from cse168_raytracer_tpu_torch.render.photon_viz import \
                photon_overlay
            write_image(args.visualize_photons,
                        photon_overlay(img, cam, scene.photons, cfg.width,
                                       cfg.height))
            _log(f"[viz] wrote {args.visualize_photons} (global=green, "
                 "caustic=red)")
    return res


def _stats_lines(scene, stats, n_rays):
    _log(f"[stats] primary={int(stats.primary_rays)} "
         f"secondary={int(stats.secondary_rays)} "
         f"shadow={int(stats.shadow_rays)} "
         f"dropped={int(stats.dropped_rays)}")
    if scene.accel is None:
        _log("[stats] no traversal counters: the render traced no tree")
        return
    # Stats.cpp:15-27; each ray's own walk, over every traversal of the
    # render (closest-hit, shadow and secondary rays)
    _log("[stats] ----- traversal (in-kernel counters, per ray, whole "
         "render) -----")
    _log(f"[stats] ray-box   tests/ray: {int(stats.box_tests) / n_rays:8.2f}")
    _log(f"[stats] ray-tri   tests/ray: {int(stats.tri_tests) / n_rays:8.2f}")


def _render_sharded(args, scene, static, cam, cfg, mesh, sync, res) -> dict:
    """The --sharded render (JAX cli.py:78-107): the frame once, and
    with --bench a second, steady-state time; process 0 writes the
    gathered frame."""
    import torch

    from cse168_raytracer_tpu_torch.parallel import distributed as dist
    from cse168_raytracer_tpu_torch.parallel.sharding import \
        render_hdr_sharded
    from cse168_raytracer_tpu_torch.render.image_io import write_image
    from cse168_raytracer_tpu_torch.render.tonemap import to_bytes, tonemap

    runs = 2 if args.bench else 1
    times = []
    with torch.no_grad():
        for _ in range(runs):
            t0 = time.perf_counter()
            hdr = render_hdr_sharded(scene, static, cam, cfg, mesh)
            sync()
            times.append(time.perf_counter() - t0)
    _log(f"[render] sharded first run {times[0]:.3f}s")
    if args.bench:
        _log(f"[render] steady-state {times[1]:.4f}s")
    t0 = time.perf_counter()
    frame = torch.as_tensor(dist.gather_image(hdr, mesh))
    res.update(hdr=frame, first_s=times[0],
               steady_s=times[1] if args.bench else None,
               gather_s=time.perf_counter() - t0, mesh=mesh)
    if res["rank"] == 0:
        write_image(args.out, to_bytes(tonemap(frame, args.tonemap)).numpy())
        _log(f"[out] wrote {args.out}")
    return res


def view(args) -> dict:
    """The `view` command (JAX cli.py:315-334): a progressive render
    that rewrites args.out after every sample. Returns the HDR image
    and the seconds it took."""
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    from cse168_raytracer_tpu_torch.render.image_io import write_image
    from cse168_raytracer_tpu_torch.render.progressive import \
        render_progressive
    from cse168_raytracer_tpu_torch.render.tonemap import to_bytes, tonemap
    from cse168_raytracer_tpu_torch.scenes.registry import build

    device = _device(args)
    cfg = RenderConfig(width=args.width, height=args.height,
                       trace_depth=args.depth, trace_samples=args.spp,
                       path_tracing=args.path_tracing)
    scene, static, cam, cfg = build(args.scene, cfg, device=device)
    scene = attach_accel(scene)

    def on_batch(done, est):
        img = to_bytes(tonemap(est.reshape(cfg.height, cfg.width, 3),
                               args.tonemap)).cpu().numpy()
        write_image(args.out, img)
        print(f"\r[view] {done}/{cfg.trace_samples} spp -> {args.out}",
              end="", file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    hdr = render_progressive(scene, static, cam, cfg, 0, on_batch=on_batch)
    _sync(device)()
    secs = time.perf_counter() - t0
    print(file=sys.stderr)
    return dict(hdr=hdr, s=secs, samples=cfg.trace_samples)


def window(args):
    """The `window` command (JAX cli.py:292-304): the interactive viewer
    on args.scene. Returns the viewer after its window closes."""
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    from cse168_raytracer_tpu_torch.render.viewer import InteractiveViewer
    from cse168_raytracer_tpu_torch.scenes.registry import build

    device = _device(args)
    cfg = RenderConfig(width=args.width, height=args.height,
                       trace_depth=args.depth)
    scene, static, cam, cfg = build(args.scene, cfg, device=device)
    viewer = InteractiveViewer(attach_accel(scene), static, cam, cfg,
                               tonemap_kind=args.tonemap)
    viewer.main_loop()
    return viewer


def _common(p, width: int, depth: int):
    p.add_argument("--scene", required=True)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; fails without a card) or cpu")
    p.add_argument("--width", type=int, default=width)
    p.add_argument("--height", type=int, default=width)
    p.add_argument("--depth", type=int, default=depth,
                   help="TRACE_DEPTH (Miro.h:13)")
    p.add_argument("--tonemap", choices=("sigmoid", "normalized", "none"),
                   default="sigmoid",
                   help="sigmoid = current reference (Scene.cpp:89); "
                        "normalized = A2-era golden-image curve")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cse168_raytracer_tpu_torch.cli", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("scenes", help="list available scenes")

    r = sub.add_parser("render", help="render a scene")
    _common(r, 512, 10)
    r.add_argument("--spp", type=int, default=1,
                   help="samples per pixel (TRACE_SAMPLES in PT/DOF mode)")
    r.add_argument("--path-tracing", action="store_true",
                   help="-DPATH_TRACING mode")
    r.add_argument("--dof", action="store_true", help="-DDOF mode")
    r.add_argument("--row-tile", type=int, default=0,
                   help="rows per wavefront chunk (bounds memory; 0 = "
                        "whole frame)")
    r.add_argument("--light-samples", type=int, default=1,
                   help="NEE samples per light (SquareLight soft shadows; "
                        "Phong.cpp:65-80)")
    r.add_argument("--no-shadows", action="store_true",
                   help="-DDISABLE_SHADOWS")
    r.add_argument("--accel", action="store_true", default=True,
                   help="use the wide SAH BVH (default on)")
    r.add_argument("--no-accel", dest="accel", action="store_false")
    r.add_argument("--stats", action="store_true", help="-DSTATS counters")
    r.add_argument("--bench", action="store_true",
                   help="time a second steady-state render of the sharded "
                        "path (the other paths always do)")
    r.add_argument("--photons", type=int, default=0,
                   help="photons per light (0 disables photon mapping)")
    r.add_argument("--caustic-photons", type=int, default=0)
    r.add_argument("--no-photon-map", action="store_true",
                   help="render without the photon maps")
    r.add_argument("--visualize-photons", default=None, metavar="PATH",
                   help="write a photon-overlay image "
                        "(-DVISUALIZE_PHOTON_MAP analog)")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--sharded", action="store_true",
                   help="shard pixel rows over the mesh (single- or "
                        "multi-process)")
    r.add_argument("--coordinator", default=None,
                   help="host:port of process 0 of a torch.distributed job")
    r.add_argument("--num-processes", type=int, default=None)
    r.add_argument("--process-id", type=int, default=None)
    r.add_argument("--progressive", action="store_true",
                   help="sample-by-sample accumulation with checkpointing")
    r.add_argument("--checkpoint", default=None,
                   help="render-state .npz path for --progressive resume")
    r.add_argument("--checkpoint-every", type=int, default=16)
    r.add_argument("--out", default="out.png")

    v = sub.add_parser("view", help="progressive preview: rewrites the "
                       "output image after every sample (the headless "
                       "counterpart of the reference's GLUT window)")
    _common(v, 256, 5)
    v.add_argument("--spp", type=int, default=64)
    v.add_argument("--path-tracing", action="store_true")
    v.add_argument("--out", default="preview.png")

    w = sub.add_parser("window", help="interactive viewer (MiroWindow's "
                       "counterpart: drag to orbit, wasd/qz to move, r/g "
                       "to toggle raytrace and preview, i to write a PPM)")
    _common(w, 256, 5)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.cmd == "scenes":
        return _cmd_scenes(args)
    if args.cmd == "view":
        view(args)
        return 0
    if args.cmd == "window":
        window(args)
        return 0
    return render(args)["rc"]


if __name__ == "__main__":
    sys.exit(main())
