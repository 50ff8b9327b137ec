"""The iteration kind "render": a closed loop of the port's render_hdr,
driven by a traffic file's parameters.

  mode        "fit": render_hdr, loss sum(hdr), backward w.r.t. `grads`
              ("kd": the material table, "v0": the triangles' first
              vertices); "frames": a forward render under no_grad;
  accel       the attach_accel kind (harness.port_scene; "auto" if not
              given);
  path_tracing, dof, spp
              the render's RenderConfig switches and samples a pixel;
  generator   "per_frame": render_hdr's own generator, seeded from the
              configuration each call; "advancing": one generator on the
              card, seeded from the run's seed, that advances frame to
              frame;
  check       "full": the reference renders every pixel; "sample": the
              `sample_pixels` pixels drawn from the seed;
  warmup_iters, trace_iters
              iterations before the window, and in a traced run.

Every iteration's kd is the configuration's kd scaled per channel by a
factor drawn from the run's seed (a table of KD_ROWS rows made on the
card in one call), so no two iterations compute the same answer and the
work is the same in all; the warm-up's rows (i < 0) are the table's
last, which no window reaches. An iteration ends when its outputs are
on the card; the caller synchronizes. The reference is check.Reference.
"""

from __future__ import annotations

import torch

KD_ROWS = 1 << 14


def seed_of(seed: int, stream: int) -> int:
    """A generator seed of stream `stream` of the run seeded `seed` (any
    non-negative integer)."""
    return (seed * 4 + stream) % (1 << 63)


class Loop:
    def __init__(self, params: dict, conf: dict, scene, static, cam, cfg,
                 seed: int, device):
        self.params = params
        self.fit = params["mode"] == "fit"
        if params["mode"] not in ("fit", "frames"):
            raise ValueError(f"unknown traffic mode {params['mode']!r}")
        self.grads = tuple(params.get("grads", ()))
        spp = int(params.get("spp", 1))
        self.cfg = cfg.replace(path_tracing=bool(params["path_tracing"]),
                               dof=bool(params["dof"]), trace_samples=spp)
        sampled = self.cfg.path_tracing or self.cfg.dof
        self.samples_per_iter = cfg.width * cfg.height * (spp if sampled
                                                          else 1)
        self.scene, self.static, self.cam = scene, static, cam
        lo, hi = conf.get("kd_scale", (1.0, 1.0))
        base = scene.materials.kd.detach()
        g = torch.Generator(device=device).manual_seed(seed_of(seed, 1))
        scale = torch.rand((KD_ROWS,) + tuple(base.shape), generator=g,
                           device=device)
        self.kd_table = base * (lo + (hi - lo) * scale)
        self.gen = None
        if params.get("generator", "per_frame") == "advancing":
            self.gen = torch.Generator(device=device).manual_seed(
                seed_of(seed, 2))
        elif params.get("generator", "per_frame") != "per_frame":
            raise ValueError(f"unknown generator {params['generator']!r}")

    def finish(self) -> dict:
        """What the check needs of the port's state (its triangle rows,
        where v0's gradient is judged); the rest is dropped."""
        state = {}
        if "v0" in self.grads:
            t = self.scene.tris
            state["tris"] = {k: getattr(t, k).detach().cpu().numpy()
                             for k in ("v0", "e1", "e2", "valid")}
        self.scene = self.static = self.cam = self.kd_table = None
        self.gen = None
        return state

    def kd(self, i: int) -> torch.Tensor:
        return self.kd_table[i % KD_ROWS]

    def __call__(self, i: int) -> dict:
        """Iteration i: {"hdr", and per grad "<name>_grad"}, and the
        inputs the reference needs: "kd", and "gen_state" where the
        generator advances."""
        from cse168_raytracer_tpu_torch.render.integrator import render_hdr
        out = {"i": i, "kd": self.kd(i)}
        if self.gen is not None:
            out["gen_state"] = self.gen.get_state()
        kd = self.kd(i).clone()
        if not self.fit:
            s = self.scene.replace(materials=self.scene.materials.replace(
                kd=kd))
            with torch.no_grad():
                out["hdr"] = render_hdr(s, self.static, self.cam, self.cfg,
                                        self.gen)[0]
            return out
        leaves = {}
        mats, tris = self.scene.materials, self.scene.tris
        if "kd" in self.grads:
            kd = leaves["kd"] = kd.requires_grad_(True)
        mats = mats.replace(kd=kd)
        if "v0" in self.grads:
            tris = tris.replace(v0=leaves.setdefault(
                "v0", tris.v0.detach().requires_grad_(True)))
        s = self.scene.replace(materials=mats, tris=tris)
        hdr, _ = render_hdr(s, self.static, self.cam, self.cfg, self.gen)
        hdr.sum().backward()
        out["hdr"] = hdr.detach()
        for name, leaf in leaves.items():
            out[name + "_grad"] = leaf.grad
        return out


def setup(cell, ctx, seed: int, device, sync) -> Loop:
    from portbench.harness import port_scene
    scene, static, cam, cfg = port_scene(cell, ctx, device, sync)
    return Loop(cell.traffic, cell.conf, scene, static, cam, cfg, seed,
                device)


def reference(cell, seed: int, device, dtype=torch.float32):
    from portbench.check import Reference
    return Reference(cell.scenes.build_raw(cell.conf), cell.conf,
                     cell.traffic, seed, device, dtype)
