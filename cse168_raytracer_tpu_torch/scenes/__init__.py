"""Named scenes (counterpart of cse168_raytracer_tpu/scenes)."""

from cse168_raytracer_tpu_torch.scenes.registry import SCENES, build  # noqa: F401
