"""The reference of the "render" iteration kind (iterations/render.py):
what the timed path produced, against the plain reference
(portbench/reference/) on the same inputs.

For each kept iteration the reference renders the same raw scene with
the iteration's kd (and, where the traffic's generator advances, the
same draws: a generator on the card set to the state the port's had
before the frame, drawing in the documented order: per sample the
pixel jitter, then the lens). A "full" check renders every pixel; a
"sample" check the pixels of a sample drawn from the run's seed. The
numbers compared are compare/<number>.py; `worst` takes each one's
largest over the kept iterations.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import scene as ref_scene
from portbench.reference.render import Camera, Renderer, block_order


def pixel_sample(width: int, height: int, k: int, seed: int) -> np.ndarray:
    """k distinct ray lanes (block order) drawn from the seed."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(width * height, size=min(k, width * height),
                              replace=False))


def triangle_match(prog: dict, ref: ref_scene.RefScene) -> np.ndarray:
    """rows (T_ref,): the port's pack row of each reference triangle,
    matched by (v0, e1, e2) bit for bit; None if the two sets differ."""
    def keys(v0, e1, e2):
        a = np.ascontiguousarray(np.concatenate([v0, e1, e2], 1),
                                 dtype=np.float32)
        return a.view(np.dtype((np.void, 36)))[:, 0]
    valid = np.flatnonzero(prog["valid"])
    kp = keys(prog["v0"][valid], prog["e1"][valid], prog["e2"][valid])
    kr = keys(ref.v0_host, ref.e1_host, ref.e2_host)
    if kp.shape != kr.shape:
        return None
    op, orr = np.argsort(kp, kind="stable"), np.argsort(kr, kind="stable")
    if not np.array_equal(kp[op], kr[orr]):
        return None
    rows = np.empty(kr.shape[0], np.int64)
    rows[orr] = valid[op]
    return rows


class Reference:
    """The reference renderer of a cell, and its outputs for kept
    iterations, in the dtype it is built with."""

    def __init__(self, raw: dict, conf: dict, params: dict, seed: int,
                 device, dtype=torch.float32):
        self.scene = ref_scene.build(raw, device, dtype)
        self.renderer = Renderer(self.scene, device, dtype)
        self.conf, self.params = conf, params
        self.width, self.height = conf["width"], conf["height"]
        self.cam = Camera(conf["camera"], self.width, self.height, device,
                          dtype)
        xs, ys = block_order(self.width, self.height)
        self.xs = torch.as_tensor(xs, device=device)
        self.ys = torch.as_tensor(ys, device=device)
        self.lanes = None
        if params.get("check", "full") == "sample":
            self.lanes = torch.as_tensor(
                pixel_sample(self.width, self.height,
                             params["sample_pixels"], seed), device=device)
        self.device, self.dtype = device, dtype
        self.cache = {}
        self.rows = None

    def outputs(self, kept: dict) -> dict:
        """The reference's {"hdr" (H, W, 3) or (K, 3) at the sampled
        lanes, and "<leaf>_grad"} for one kept iteration's inputs."""
        p = self.params
        spp = int(p.get("spp", 1))
        sampled = p["path_tracing"] or p["dof"]
        depth = self.conf["trace_depth"]
        n = self.width * self.height
        lanes = (torch.arange(n, device=self.device) if self.lanes is None
                 else self.lanes)
        xs, ys = self.xs[lanes], self.ys[lanes]
        kd = kept["kd"].detach().to(self.dtype).clone()
        v0 = self.scene.v0.clone()
        grads = p.get("grads", ()) if p["mode"] == "fit" else ()
        kd.requires_grad_("kd" in grads)
        v0.requires_grad_("v0" in grads)
        gen = None
        if "gen_state" in kept:
            gen = torch.Generator(device=self.device)
            gen.set_state(kept["gen_state"])
        with torch.set_grad_enabled(bool(grads)):
            acc = None
            for _ in range(spp if sampled else 1):
                jitter = lens = None
                if sampled:
                    jitter = torch.rand((n, 2), generator=gen,
                                        device=self.device)[lanes]
                    if p["dof"]:
                        lens = torch.rand((n, 2), generator=gen,
                                          device=self.device)[lanes]
                o, d = self.cam.rays(
                    xs, ys, jitter, lens,
                    self.conf.get("dof_aperture", 0.2) if p["dof"] else 0.0,
                    self.conf.get("dof_focus_plane", 15.3))
                rad = self.renderer.trace(
                    o, d, kd, v0, depth,
                    cache=None if sampled else self.cache)
                acc = rad if acc is None else acc + rad
            if sampled:
                acc = acc / spp
            out = {}
            if self.lanes is None:
                img = torch.zeros((self.height, self.width, 3),
                                  dtype=acc.dtype, device=self.device)
                img = img.index_put((ys, xs), acc)
                out["hdr"] = img
            else:
                out["hdr"] = acc
            if grads:
                out["hdr"].sum().backward()
                for name, leaf in (("kd", kd), ("v0", v0)):
                    if name in grads:
                        out[name + "_grad"] = leaf.grad
        return {k: v.detach().float() for k, v in out.items()}

    def view(self, prog: dict, state: dict) -> dict:
        """The port's outputs of an iteration in the reference's layout:
        the sampled pixels, and v0's gradient in reference order (its
        rows matched by `state`'s triangle rows; None where they do not
        match)."""
        out = {}
        hdr = prog["hdr"].float()
        if self.lanes is not None:
            hdr = hdr[self.ys[self.lanes], self.xs[self.lanes]]
        out["hdr"] = hdr
        if "kd_grad" in prog:
            out["kd_grad"] = prog["kd_grad"].float()
        if "v0_grad" in prog:
            if self.rows is None and "tris" in state:
                self.rows = triangle_match(state["tris"], self.scene)
            rows = self.rows
            out["v0_grad"] = (None if rows is None else
                              prog["v0_grad"].float()[torch.as_tensor(
                                  rows, device=prog["v0_grad"].device)])
        return out


def worst(readings: list) -> dict:
    """Each number's largest value over the iterations' readings."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, -1.0), v)
    return out
