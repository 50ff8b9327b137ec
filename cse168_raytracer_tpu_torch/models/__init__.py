"""Scene data: geometry, materials, lights, textures, scene (counterpart of cse168_raytracer_tpu/models)."""
