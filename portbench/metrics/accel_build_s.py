"""Host seconds of attach_accel("auto") in set-up, ended by a
synchronize (the scene-build layer: ops/accel.py, ops/sah.py and the
wide tree's build in ops/wide_bvh.py)."""


def read(ctx):
    return ctx.spans.get("accel_build_s")
