"""PyTorch/CUDA port of the differentiable Whitted and path tracer.

Counterpart of the JAX package `cse168_raytracer_tpu`, module for module
(each module's docstring names its JAX twin). The port imports `torch`
and never `jax` or `cse168_raytracer_tpu`. The BVH traversal runs in a
hand-written CUDA kernel for Hopper (csrc/traverse_wide.cu) on CUDA
tensors and in its plain PyTorch versions on CPU tensors. The command
line is `python -m cse168_raytracer_tpu_torch.cli`.
"""
