"""Multi-process rendering and training over torch.distributed.

Counterpart of cse168_raytracer_tpu/parallel/distributed.py:41-129. The
reference scales only over OpenMP threads on scanlines
(Scene.cpp:112-115); the JAX package joins processes with
jax.distributed and renders over one global mesh. Here each process
joins a torch.distributed process group and owns a contiguous run of
the mesh's shards (parallel/sharding.py renders them):

    python -m cse168_raytracer_tpu_torch.cli render --scene sphere \
        --sharded --coordinator 10.0.0.1:8476 --num-processes 2 \
        --process-id $i ...

or from Python:

    from cse168_raytracer_tpu_torch.parallel import distributed as dist
    dist.init_multihost(coordinator, num_processes, process_id)
    mesh = dist.global_mesh()
    hdr = render_hdr_sharded(scene, static, cam, cfg, mesh)
    img = dist.gather_image(hdr, mesh)     # full frame on every process

Which collectives run where: the forward render needs none. gather_image
and train_step_sharded's gradients use all_reduce(SUM), photon emission
all_gather and all_reduce(SUM). Under NCCL they run on the card's
tensors. NCCL refuses two ranks on one card ("Duplicate GPU detected"),
so ranks that share a card name backend="gloo", and under gloo every
collective runs on a host copy of the tensor, copied back to its
device after. A failed init or collective raises; nothing falls back
to another backend or to the CPU. Single-process (no coordinator, at
most one process, no torchrun environment) init_multihost is a no-op
and the mesh is local.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from cse168_raytracer_tpu_torch.config import resolve_device

TIMEOUT = datetime.timedelta(minutes=5)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The row shards of a render: how many, which this process renders
    (contiguous, in order), the process group joining the processes
    (None: one process renders every shard) and the device."""
    n_shards: int
    local_shards: tuple
    group: Optional[object]
    device: torch.device

    @property
    def size(self) -> int:
        return self.n_shards


def _cluster_env() -> bool:
    """True under torchrun (or any launcher that sets MASTER_ADDR and a
    WORLD_SIZE above 1), the port's counterpart of the JAX package's
    cluster variables."""
    return bool(os.environ.get("MASTER_ADDR")) and int(
        os.environ.get("WORLD_SIZE", "1")) > 1


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None, device=None) -> int:
    """Join the job's process group; returns this process's rank.

    coordinator "host:port" of rank 0 (init_method tcp://), with
    num_processes and process_id; or, with no coordinator, torchrun's
    environment (env://). backend defaults to "nccl" for a CUDA device
    and "gloo" for the CPU (device None: the card). A no-op returning 0
    in a single process; idempotent."""
    single = (coordinator is None and num_processes in (None, 1)
              and not _cluster_env())
    if single:
        return 0
    if dist.is_initialized():
        return dist.get_rank()
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if coordinator is None:
        kw = dict(init_method="env://")
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        kw = dict(init_method="tcp://" + coordinator,
                  world_size=num_processes, rank=process_id)
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, timeout=TIMEOUT, **kw)
    return dist.get_rank()


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(shards_per_process: int = 1, device=None) -> Mesh:
    """The mesh over every process of the job: shards_per_process shards
    a process, rank r owning shards [r s, (r + 1) s). Single-process it
    is parallel.sharding.make_mesh(shards_per_process)."""
    device = resolve_device(device)
    if dist.is_initialized():
        world, rank, group = (dist.get_world_size(), dist.get_rank(),
                              dist.group.WORLD)
    else:
        world, rank, group = 1, 0, None
    spp = shards_per_process
    return Mesh(world * spp, tuple(range(rank * spp, (rank + 1) * spp)),
                group, device)


def process_tile_rows(height: int, mesh: Mesh):
    """(row0, n_rows): this process's span of the sharded row buffer
    (shard s's rows at [s h/n, (s + 1) h/n)). Rows go to shards
    cyclically in image space (shard s renders image rows s, s + n, ...),
    so the span indexes that buffer, not contiguous image rows; n_rows is
    this process's share of the work. Raises ValueError when the height
    does not divide over the shards or this process's shards are not
    contiguous (the JAX function asserts both)."""
    n = mesh.n_shards
    if height % n:
        raise ValueError(f"height {height} must divide over {n} shards")
    h_loc = height // n
    ids = sorted(mesh.local_shards)
    if not ids:
        return 0, 0
    if ids[-1] - ids[0] + 1 != len(ids):
        raise ValueError("this process's shards are not contiguous in the "
                         f"mesh: {ids}")
    return ids[0] * h_loc, len(ids) * h_loc


def _on_host(mesh: Mesh, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(mesh.group) == "gloo"


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The element-wise sum of t over the mesh's processes (t itself in
    one process), on t's device."""
    if mesh.group is None:
        return t
    x = t.detach().cpu() if _on_host(mesh, t) else t.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x.to(t.device)


def all_gather_cat(t: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """Every process's t (all of one shape), concatenated along dim in
    rank order, on t's device."""
    if mesh.group is None:
        return t
    x = t.detach().contiguous()
    if _on_host(mesh, t):
        x = x.cpu()
    parts = [torch.empty_like(x)
             for _ in range(dist.get_world_size(mesh.group))]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim).to(t.device)


def gather_image(frame: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """The full frame on every process as a host array. frame is
    render_hdr_sharded's: this process's rows filled, the others zero,
    so a sum over the processes assembles the frame exactly."""
    return all_reduce_sum(frame.detach(), mesh).cpu().numpy()
