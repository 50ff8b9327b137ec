"""Seconds from the process's start to the first timed iteration:
imports, CUDA's start, the scene and its accelerator, the warm-up."""


def read(ctx):
    return ctx.setup_s
