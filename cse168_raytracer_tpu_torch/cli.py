"""Command-line entry point of the port (counterpart of
cse168_raytracer_tpu/cli.py:19-289: main.cpp's headless path, pick a
scene, render, write the image).

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
    python -m cse168_raytracer_tpu_torch.cli scenes      # list scenes

It renders on the card (--device cuda, the default) unless --device cpu
is given, and never falls back to the CPU. The render is timed twice,
its first run and then a second, steady-state run of the same seed. It
prints [scene], [accel], [render], [stats] and [out] lines on stderr, as
the JAX package's command line does; --stats adds the ray counts and the
traversal's in-kernel counters, which in the port are each ray's own
walk (the JAX package bills a tile's visits to each of its rays).
--photons N builds the photon maps first (N global photons per
directional-area light, --caustic-photons M caustic ones; the
generator is seeded with --seed + 7) and prints a [photons] line, and
with --stats or --visualize-photons each map's emitted, stored and
bounce counts; --visualize-photons PATH writes the stored photons over
the frame (global green, caustic red); --no-photon-map renders without
the maps.
Options of the JAX command line that the port does not have yet exit
with status 2 and name their ROADMAP item.
"""

from __future__ import annotations

import argparse
import sys
import time

# options and commands of the JAX command line not ported yet, with the
# ROADMAP item that brings them
NOT_PORTED = {
    "sharded": "multi-device rendering (ROADMAP item A24)",
    "coordinator": "multi-host rendering (ROADMAP item A24)",
    "num_processes": "multi-host rendering (ROADMAP item A24)",
    "process_id": "multi-host rendering (ROADMAP item A24)",
    "progressive": "progressive rendering (ROADMAP item A24)",
    "checkpoint": "render checkpoints (ROADMAP item A24)",
    "checkpoint_every": "render checkpoints (ROADMAP item A24)",
}
NOT_PORTED_COMMANDS = {
    "view": "the progressive preview (ROADMAP item A24)",
    "window": "the interactive viewer (ROADMAP item A24)",
}


def _log(*args):
    print(*args, file=sys.stderr, flush=True)


def _cmd_scenes(_args) -> int:
    from cse168_raytracer_tpu_torch.scenes import SCENES
    for name in sorted(SCENES):
        print(name)
    return 0


def _unported(args) -> list[str]:
    """The unported options the command line set."""
    bad = []
    for name, what in NOT_PORTED.items():
        value = getattr(args, name)
        if value not in (None, False):
            bad.append(f"--{name.replace('_', '-')}: {what}")
    return bad


def render(args, built=None) -> dict:
    """The `render` command on parsed arguments: build args.scene (or
    take `built`, that scene's (Scene, SceneStatic, Camera) as
    scenes.build gives them), build its photon maps when asked, render
    it twice, write args.out (and the photon overlay). Returns the HDR
    image, the RenderStats, the timings and the photon counts."""
    import torch

    from cse168_raytracer_tpu_torch.config import (RenderConfig,
                                                   resolve_device)
    from cse168_raytracer_tpu_torch.render.image_io import write_image
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    from cse168_raytracer_tpu_torch.render.tonemap import to_bytes, tonemap
    from cse168_raytracer_tpu_torch.scenes.registry import build

    device = resolve_device(args.device)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    cfg = RenderConfig(
        width=args.width, height=args.height, trace_depth=args.depth,
        trace_samples=args.spp, path_tracing=args.path_tracing,
        dof=args.dof, disable_shadows=args.no_shadows,
        light_samples=args.light_samples, row_tile=args.row_tile,
        photons_per_light=args.photons,
        caustic_photons_per_light=args.caustic_photons,
        collect_stats=args.stats, seed=args.seed)

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

    times = []
    with torch.no_grad():
        for _ in range(2):
            t0 = time.perf_counter()
            hdr, stats = render_hdr(scene, static, cam, cfg)
            sync()
            times.append(time.perf_counter() - t0)
    n_rays = (int(stats.primary_rays) + int(stats.secondary_rays)
              + int(stats.shadow_rays))
    samples = cfg.trace_samples if (cfg.path_tracing or cfg.dof) else 1
    _log(f"[render] first run {times[0]:.3f}s, steady-state "
         f"{times[1]:.4f}s ({times[1] * 1e3 / samples:.3f} ms/sample, "
         f"{samples} spp); {n_rays} rays, {n_rays / times[1]:.1f} rays/s")
    if args.stats:
        _log(f"[stats] primary={int(stats.primary_rays)} "
             f"secondary={int(stats.secondary_rays)} "
             f"shadow={int(stats.shadow_rays)} "
             f"dropped={int(stats.dropped_rays)}")
        if scene.accel is None:
            _log("[stats] no traversal counters: the render traced no tree")
        else:
            # Stats.cpp:15-27; each ray's own walk, over every traversal
            # of the render (closest-hit, shadow and secondary rays)
            _log("[stats] ----- traversal (in-kernel counters, per ray, "
                 "whole render) -----")
            _log(f"[stats] ray-box   tests/ray: "
                 f"{int(stats.box_tests) / n_rays:8.2f}")
            _log(f"[stats] ray-tri   tests/ray: "
                 f"{int(stats.tri_tests) / n_rays:8.2f}")
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
    return dict(hdr=hdr, stats=stats, first_s=times[0], steady_s=times[1],
                rays=n_rays, samples=samples, device=device,
                photons=scene.photons, photon_stats=photon_stats)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cse168_raytracer_tpu_torch.cli", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("scenes", help="list available scenes")

    r = sub.add_parser("render", help="render a scene")
    r.add_argument("--scene", required=True)
    r.add_argument("--device", default="cuda",
                   help="cuda (the default; fails without a card) or cpu")
    r.add_argument("--width", type=int, default=512)
    r.add_argument("--height", type=int, default=512)
    r.add_argument("--depth", type=int, default=10,
                   help="TRACE_DEPTH (Miro.h:13)")
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
                   help="time a second steady-state render; the port "
                        "always does, so this changes nothing")
    r.add_argument("--photons", type=int, default=0,
                   help="photons per light (0 disables photon mapping)")
    r.add_argument("--caustic-photons", type=int, default=0)
    r.add_argument("--no-photon-map", action="store_true",
                   help="render without the photon maps")
    r.add_argument("--visualize-photons", default=None, metavar="PATH",
                   help="write a photon-overlay image "
                        "(-DVISUALIZE_PHOTON_MAP analog)")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--tonemap", choices=("sigmoid", "normalized", "none"),
                   default="sigmoid",
                   help="sigmoid = current reference (Scene.cpp:89); "
                        "normalized = A2-era golden-image curve")
    r.add_argument("--out", default="out.png")
    for name, what in NOT_PORTED.items():
        flag, kw = "--" + name.replace("_", "-"), {"help": f"not ported: {what}"}
        if name in ("sharded", "progressive"):
            kw["action"] = "store_true"
        r.add_argument(flag, **kw)
    for name, what in NOT_PORTED_COMMANDS.items():
        sub.add_parser(name, help=f"not ported: {what}")
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in NOT_PORTED_COMMANDS:
        _log(f"error: `{argv[0]}`: {NOT_PORTED_COMMANDS[argv[0]]} is not "
             "ported yet")
        return 2
    args = parser().parse_args(argv)
    if args.cmd == "scenes":
        return _cmd_scenes(args)
    bad = _unported(args)
    if bad:
        for line in bad:
            _log(f"error: {line} is not ported yet")
        return 2
    render(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
