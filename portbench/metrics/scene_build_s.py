"""Seconds of the port's outermost scene.build phases in the run's
set-up (cse168_raytracer_tpu_torch/utils/profiling.py): the registry's
build, make_scene and pack_triangles, from the meshes to the scene on
the device; attach_accel is accel_build_s."""


def read(ctx):
    from cse168_raytracer_tpu_torch.utils import profiling
    return profiling.spans().get("scene.build")
