"""Intersection, acceleration, surfaces and shading (counterpart of cse168_raytracer_tpu/ops)."""
