"""The port against the reference renderer's own output.

`test_sphere` (main.cpp:30: mirror and diffuse spheres over a checkered
plane, deterministic point lights) rendered by the port at 512x512 and
trace depth 10, tonemapped and quantized, must meet tests/test_golden.py's
bar against the reference binary's tests/golden/testsphere.ppm: at least
99.9% of the bytes within +-2 and a mean |difference| of at most 0.05."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cse168_raytracer_tpu_torch.config import RenderConfig  # noqa: E402
from cse168_raytracer_tpu_torch.ops.accel import attach_accel  # noqa: E402
from cse168_raytracer_tpu_torch.render.integrator import \
    render_hdr  # noqa: E402
from cse168_raytracer_tpu_torch.render.tonemap import (  # noqa: E402
    sigmoid_tonemap, to_bytes)
from cse168_raytracer_tpu_torch.scenes import build  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "testsphere.ppm")


def share_cores_between_workers():
    """Under pytest-xdist, give each worker's torch an equal share of the
    cores. By default every worker runs one thread per core; with six
    workers on eight cores the port's tests then ran 3.5 times slower
    than with one thread each, their threads waiting on each other. The
    other port test files import this module for the call below."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        torch.set_num_threads(max(1, torch.get_num_threads() // workers))


share_cores_between_workers()


def load_ppm(path):
    with open(path, "rb") as f:
        assert f.readline().strip() == b"P6"
        w, h = map(int, f.readline().split())
        assert f.readline().strip() == b"255"
        return np.frombuffer(f.read(), np.uint8).reshape(h, w, 3)


def test_golden_test_sphere():
    ref = load_ppm(GOLDEN)
    cfg = RenderConfig(width=512, height=512, trace_depth=10)
    scene, static, cam, cfg = build("test_sphere", cfg, device="cpu")
    scene = attach_accel(scene)
    assert scene.accel is None      # spheres and a plane only
    with torch.no_grad():
        hdr, stats = render_hdr(scene, static, cam, cfg)
    assert int(stats.secondary_rays) > 0
    ours = to_bytes(sigmoid_tonemap(hdr)).numpy()[::-1]    # to top-down
    diff = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
    frac_close = float(np.mean(diff <= 2))
    mean_diff = float(diff.mean())
    assert frac_close >= 0.999 and mean_diff <= 0.05, (
        f"{frac_close * 100:.2f}% of bytes within +-2 (need 99.9%), "
        f"mean|diff| {mean_diff:.4f} (max {int(diff.max())})")
