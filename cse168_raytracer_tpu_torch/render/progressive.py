"""Progressive (resumable) sampled rendering.

Counterpart of cse168_raytracer_tpu/render/progressive.py:25-72: the
wavefront integrator drives cfg.trace_samples jittered samples per
pixel, one sample per pass over the whole frame (row-major pixels),
into a running HDR sum that utils/checkpoint.py saves every
`checkpoint_every` samples and at the end, so a long render survives
an interruption (SURVEY.md §5: the reference has no such recovery).

Sample i draws its pixel jitter, lens, square-light origins and lobes
from a generator on the scene's device seeded with
core/sampling.fold_seed(seed, i) (the JAX package splits a key per
sample instead). So a run stopped after k samples and resumed from its
file consumes the same streams as a straight run and gives the same
image, bit for bit on one device.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from cse168_raytracer_tpu_torch.config import RenderConfig
from cse168_raytracer_tpu_torch.core.sampling import stream
from cse168_raytracer_tpu_torch.render.camera import Camera, draw_eye_rays
from cse168_raytracer_tpu_torch.render.integrator import integrate
from cse168_raytracer_tpu_torch.utils import console
from cse168_raytracer_tpu_torch.utils.checkpoint import (load_render_state,
                                                         save_render_state)


@torch.no_grad()
def render_progressive(scene, static, cam: Camera, cfg: RenderConfig,
                       seed: int, checkpoint_path: Optional[str] = None,
                       checkpoint_every: int = 16,
                       on_batch: Optional[Callable] = None):
    """Render cfg.trace_samples samples per pixel, resuming from
    checkpoint_path when that file exists (its seed then replaces
    `seed`, as the JAX package takes the file's key). on_batch(done,
    (pixels, 3) running mean) is called after every sample. Returns the
    (H, W, 3) HDR mean over the samples, without a gradient (the saved
    sum could not carry one)."""
    w, h = cfg.width, cfg.height
    n_pix = w * h
    dev = scene.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w, device=dev), indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    pixel = ys * w + xs

    def one_sample(i):
        gen = stream(seed, i, dev)
        o, d = draw_eye_rays(
            cam, xs, ys, w, h, gen,
            dof_aperture=cfg.dof_aperture if cfg.dof else 0.0,
            dof_focus=cfg.dof_focus_plane)
        return integrate(scene, static, o, d, pixel, n_pix, cfg.trace_depth,
                         gen=gen, path_tracing=cfg.path_tracing,
                         disable_shadows=cfg.disable_shadows)[0]

    accum = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    done = 0
    if checkpoint_path:
        state = load_render_state(checkpoint_path, dev)
        if state is not None:
            accum, done, seed = state
            console.info("[progressive] resumed at %d/%d samples", done,
                         cfg.trace_samples)

    while done < cfg.trace_samples:
        accum = accum + one_sample(done)
        done += 1
        if on_batch is not None:
            on_batch(done, accum / done)
        if checkpoint_path and (done % checkpoint_every == 0
                                or done == cfg.trace_samples):
            if accum.is_cuda:
                torch.cuda.synchronize(accum.device)
            save_render_state(checkpoint_path, accum, done, seed)
    return (accum / max(done, 1)).reshape(h, w, 3)
