"""The plain reference the benchmark holds the port against.

Plain PyTorch and NumPy, written from the renderer's semantics (the
reference C++ tracer's Whitted integrator, Phong shading and camera, as
the port documents them), importing nothing of the port. It is given
the raw scene (meshes, materials, lights, camera) that the benchmark
makes, never a table that the port built from it.
"""
