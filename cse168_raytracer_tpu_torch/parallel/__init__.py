"""Row-sharded rendering and training over torch.distributed
(counterpart of cse168_raytracer_tpu/parallel; the reference's OpenMP
scanline fork, Scene.cpp:112-115)."""

from cse168_raytracer_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh, render_hdr_sharded, train_step_sharded)
