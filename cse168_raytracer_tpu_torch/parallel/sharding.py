"""Row-sharded rendering and differentiable training.

Counterpart of cse168_raytracer_tpu/parallel/sharding.py:39-151, where
shard_map spreads pixel rows over a device mesh. Here a Mesh
(parallel/distributed.py) lists the shards each process renders, in
turn; `make_mesh(n)` renders all n in one process, the counterpart of
the JAX package's virtual CPU mesh, and `distributed.global_mesh`
spreads them over the processes of a torch.distributed job.

Rows go to shards cyclically: shard s renders image rows s, s + n,
s + 2n, ... (the static analog of the reference's schedule(dynamic, 2),
Scene.cpp:112-115, which spreads a centred subject's work over the
shards). Shard s draws from a generator seeded with
core/sampling.fold_seed(cfg.seed, s), as the JAX package folds the
shard index into its key, uses tile-local pixel ids, and for path
tracing or depth of field averages cfg.trace_samples samples. The
forward pass needs no communication. The scene and materials are
whole on every process; train_step_sharded sums the material
gradients over the processes with all_reduce(SUM), the counterpart of
shard_map's psum, so every rank takes the same step.
"""

from __future__ import annotations

import torch

from cse168_raytracer_tpu_torch.config import RenderConfig, resolve_device
from cse168_raytracer_tpu_torch.core.sampling import stream
from cse168_raytracer_tpu_torch.models.scene import Scene, SceneStatic
from cse168_raytracer_tpu_torch.parallel.distributed import (Mesh,
                                                             all_reduce_sum)
from cse168_raytracer_tpu_torch.render.camera import (Camera, draw_eye_rays,
                                                      eye_rays)
from cse168_raytracer_tpu_torch.render.integrator import integrate


def make_mesh(n_shards: int, device=None) -> Mesh:
    """A mesh of n_shards row shards, all rendered by this process."""
    return Mesh(n_shards, tuple(range(n_shards)), None,
                resolve_device(device))


def _tile(scene, static, cam, cfg, s: int, n: int):
    """Shard s of n: its (h/n, w, 3) rows s, s + n, ... in order."""
    w, h = cfg.width, cfg.height
    h_loc = h // n
    dev = scene.device
    ys = (s + n * torch.arange(h_loc, device=dev))[:, None].expand(h_loc, w)
    xs = torch.arange(w, device=dev).expand(h_loc, w)
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    pixel = torch.arange(h_loc * w, device=dev)      # tile-local ids
    gen = stream(cfg.seed, s, dev)

    def one(o, d):
        return integrate(scene, static, o, d, pixel, h_loc * w,
                         cfg.trace_depth, gen=gen,
                         path_tracing=cfg.path_tracing,
                         disable_shadows=cfg.disable_shadows)[0]

    if cfg.path_tracing or cfg.dof:
        acc = 0.0
        for _ in range(cfg.trace_samples):
            acc = acc + one(*draw_eye_rays(
                cam, xs, ys, w, h, gen,
                dof_aperture=cfg.dof_aperture if cfg.dof else 0.0,
                dof_focus=cfg.dof_focus_plane))
        r = acc / cfg.trace_samples
    else:
        r = one(*eye_rays(cam, xs, ys, w, h))
    return r.reshape(h_loc, w, 3)


def local_rows(height: int, mesh: Mesh) -> torch.Tensor:
    """The image rows this process renders, ascending."""
    n = mesh.n_shards
    rows = torch.arange(height, device=mesh.device)
    return rows[torch.isin(rows % n, torch.tensor(mesh.local_shards,
                                                  device=mesh.device))]


def render_hdr_sharded(scene: Scene, static: SceneStatic, cam: Camera,
                       cfg: RenderConfig, mesh: Mesh) -> torch.Tensor:
    """Scene::raytraceImage with pixel rows sharded over the mesh.
    Returns the (H, W, 3) HDR frame in image row order, the rows of
    other processes' shards zero (distributed.gather_image assembles the
    frame). Raises ValueError when the height does not divide over the
    shards."""
    n = mesh.n_shards
    w, h = cfg.width, cfg.height
    if h % n:
        raise ValueError(f"height {h} must divide over {n} shards")
    h_loc = h // n
    tiles = [_tile(scene, static, cam, cfg, s, n) if s in mesh.local_shards
             else torch.zeros((h_loc, w, 3), device=scene.device)
             for s in range(n)]
    # tiles[s][j] is image row j n + s
    return torch.stack(tiles, 1).reshape(h, w, 3)


def train_step_sharded(scene: Scene, static: SceneStatic, cam: Camera,
                       cfg: RenderConfig, mesh: Mesh, target: torch.Tensor,
                       lr: float = 1e-2):
    """One differentiable-render training step: the L2 loss between the
    sharded render and target, a mean over the whole frame; each
    process backpropagates its own rows, the gradients of kd, ks and kt
    are summed over the processes, and SGD gives every rank the same
    tables. Returns (new scene, loss)."""
    mats = scene.materials
    params = [x.detach().clone().requires_grad_(True)
              for x in (mats.kd, mats.ks, mats.kt)]
    kd, ks, kt = params
    s = scene.replace(materials=mats.replace(kd=kd, ks=ks, kt=kt))
    hdr = render_hdr_sharded(s, static, cam, cfg, mesh)
    rows = local_rows(cfg.height, mesh)
    diff = (hdr - target.to(hdr.device))[rows]
    loss = (diff * diff).sum() / hdr.numel()
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else all_reduce_sum(g, mesh)
             for p, g in zip(params, grads)]
    kd, ks, kt = (p.detach() - lr * g for p, g in zip(params, grads))
    new_scene = scene.replace(materials=mats.replace(kd=kd, ks=ks, kt=kt))
    return new_scene, all_reduce_sum(loss.detach(), mesh)
