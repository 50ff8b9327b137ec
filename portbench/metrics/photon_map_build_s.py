"""Seconds of the port's photons.build phase in the run's set-up
(cse168_raytracer_tpu_torch/utils/profiling.py; ops/photon.py
build_photon_maps): the emission batches traced through the traversal,
the photons copied to the host, the radius and both levels of both
grids built and uploaded."""


def read(ctx):
    from cse168_raytracer_tpu_torch.utils import profiling
    return profiling.spans().get("photons.build")
