"""The iteration kind "photon": the "render" kind's closed loop of
forward frames (iterations/render.py) on a scene that carries photon
maps, as cli render --photons --caustic-photons renders.

Set-up builds the scene (harness.port_scene), then the global and
caustic maps once (ops/photon.py build_photon_maps, the configuration's
RenderConfig giving their sizes) from the configuration's kd, with a
generator seeded from the run's seed (stream 3), as cli render builds
them once before its frames. Each frame's kd is drawn from the seed as
in the "render" kind: it shades the gather points and moves no photon.

What the check reads of the build: the generator's state at its start
and each map's photons as the port stored them (PhotonMaps.photons:
position, incoming direction, power over the photons emitted), both on
every iteration's outputs; and from finish(), each grid's stored
photons and their power summed. The reference (Reference below) replays
the tracing from the state; its photons are compared with the port's
row for row as sets (compare/photon_set_off.py) and by their power sums
(compare/map_power_err.py). For the frames it builds its own grids over
the port's photons: a grid's fold of over-full buckets draws from one
random stream bucket after bucket, so a photon that lands a cell away
in an independent trace moves every later draw (at full size two
traces part within the first few thousand photons, where both triangles
of a quad take a ray), and frames over such maps differ by their
sampling noise, ~50% a pixel (PERF.md section 2).

On the card set-up loads the traversal kernels before the build, so
the build's phase (photons.build, read by photon_map_build_s) holds no
compiler run in a checkout's first process. A port whose maps keep no
photons cannot be checked: set-up stops at once, before any build.
"""

from __future__ import annotations

import torch

from portbench.check import Reference as FrameReference
from portbench.iterations import render
from portbench.reference import photon as ref_photon

GRIDS = ("global_map", "caustic_map")


class Loop(render.Loop):
    def __init__(self, params, conf, scene, static, cam, cfg, seed, device,
                 build_state, photons):
        super().__init__(params, conf, scene, static, cam, cfg, seed, device)
        self.build = {"state": build_state, "photons": photons}

    def __call__(self, i: int) -> dict:
        out = super().__call__(i)
        out["build"] = self.build
        return out

    def finish(self) -> dict:
        """The grids' numbers ("map_power" (2, 3) float64 and "map_stored"
        (2,), global then caustic, zeros for a map the scene lacks); the
        rest of the state dropped."""
        maps = self.scene.photons
        power = torch.zeros((2, 3), dtype=torch.float64)
        stored = torch.zeros(2, dtype=torch.int64)
        for j, name in enumerate(GRIDS):
            grid = None if maps is None else getattr(maps, name)
            if grid is not None:
                power[j] = grid.power.double().sum(0).cpu()
                stored[j] = grid.n_valid
        state = super().finish()
        state.update(map_power=power, map_stored=stored)
        return state


def rows(photons) -> torch.Tensor:
    """A map's photons (position, direction, power) as (N, 9) float32."""
    return torch.cat([torch.as_tensor(x).float().reshape(-1, 3)
                      for x in photons], 1)


def setup(cell, ctx, seed: int, device, sync) -> Loop:
    import dataclasses
    from cse168_raytracer_tpu_torch.ops import photon as ph
    if "photons" not in {f.name for f in dataclasses.fields(ph.PhotonMaps)}:
        raise RuntimeError("the port's PhotonMaps keep no photons "
                           "(PhotonMaps.photons): nothing to check the "
                           "photon tracer against")
    from portbench.harness import port_scene
    scene, static, cam, cfg = port_scene(cell, ctx, device, sync)
    gen = torch.Generator(device=device).manual_seed(render.seed_of(seed, 3))
    state = gen.get_state()
    if device.type == "cuda":
        from cse168_raytracer_tpu_torch.ops import cuda_build
        cuda_build.load_library("traverse_wide.cu")
    maps = ph.build_photon_maps(scene, static, cfg, gen)
    sync()
    photons = (dict.fromkeys(ref_photon.MAPS) if maps is None
               else maps.photons)
    return Loop(cell.traffic, cell.conf, scene.replace(photons=maps), static,
                cam, cfg, seed, device, state, photons)


class Reference(FrameReference):
    """check.Reference's Whitted frames plus the maps' share
    (reference/photon.py photon_term) over grids it builds from the
    port's photons (its own replayed ones for a map the port lacks), the
    power sums of its own replayed photons, and those photons as rows
    ("photons_<map>", (N, 9) float32: position, direction, power; None
    for a map without photons); all made once, from the first kept
    iteration's "build" (none depends on a frame's kd: a scaled kd keeps
    its zeros)."""

    def __init__(self, cell, seed: int, device, dtype=torch.float32):
        self.raw = cell.scenes.build_raw(cell.conf)
        super().__init__(self.raw, cell.conf, cell.traffic, seed, device,
                         dtype)
        self.photon_conf = cell.conf["photons"]
        self.numbers = self.term = self.port_rows = None

    def _photons(self, build: dict):
        tracer = ref_photon.Tracer(self.raw, self.scene, self.renderer.cl,
                                   self.device, self.dtype)
        own = ref_photon.trace_maps(tracer, self.photon_conf,
                                    build["state"], self.device)
        self.numbers = ref_photon.map_numbers(own)
        self.numbers.update({
            "photons_" + name: (None if own[name] is None else
                                rows(own[name]).to(self.device))
            for name in ref_photon.MAPS})
        maps = {}
        for name in ref_photon.MAPS:
            photons = build["photons"].get(name)
            if photons is None:
                photons = own[name]
            maps[name] = (None if photons is None else
                          ref_photon.PhotonMap(photons, self.photon_conf,
                                               self.device, self.dtype))
        lanes = (torch.arange(self.width * self.height, device=self.device)
                 if self.lanes is None else self.lanes)
        o, d = ref_photon.camera_rays(self.conf["camera"], self.xs[lanes],
                                      self.ys[lanes], self.width,
                                      self.height, self.device, self.dtype)
        term = ref_photon.photon_term(tracer, maps, o, d,
                                      self.conf["trace_depth"]).float()
        if self.lanes is None:
            term = torch.zeros((self.height, self.width, 3),
                               device=self.device).index_put(
                (self.ys, self.xs), term)
        self.term = term

    def outputs(self, kept: dict) -> dict:
        if self.term is None:
            self._photons(kept["build"])
        out = super().outputs(kept)
        out["hdr"] = out["hdr"] + self.term
        out.update(self.numbers)
        return out

    def view(self, prog: dict, state: dict) -> dict:
        out = super().view(prog, state)
        if self.port_rows is None:
            photons = prog["build"]["photons"]
            self.port_rows = {
                "photons_" + name: (None if photons.get(name) is None else
                                    rows(photons[name]).to(self.device))
                for name in ref_photon.MAPS}
        out.update(self.port_rows)
        out.update(map_power=state["map_power"],
                   map_stored=state["map_stored"])
        return out


def reference(cell, seed: int, device, dtype=torch.float32):
    return Reference(cell, seed, device, dtype)
