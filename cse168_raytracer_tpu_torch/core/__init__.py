"""Vector math and row lookups (counterpart of cse168_raytracer_tpu/core)."""
