"""Camera, integrator and tonemap (counterpart of cse168_raytracer_tpu/render)."""
