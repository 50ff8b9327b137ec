"""The port's progressive rendering, render-state checkpoints, console
and phase timing against the JAX package's.

A progressive render resumed from its checkpoint equals the straight
run bit for bit (both consume the streams fold_seed(seed, i)); a state
file the JAX package wrote raises ValueError (its random key cannot be
continued); the progressive image compares with the JAX package's
statistically, by test_torch_pathtrace.py's block-RMS bar (PyTorch
cannot replay jax.random)."""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import test_torch_golden  # noqa: E402,F401  (shares the cores between workers)

from cse168_raytracer_tpu.config import RenderConfig as JCfg  # noqa: E402
from cse168_raytracer_tpu.ops.accel import attach_accel as j_attach  # noqa: E402
from cse168_raytracer_tpu.render.progressive import \
    render_progressive as j_progressive  # noqa: E402
from cse168_raytracer_tpu.scenes import build as j_build  # noqa: E402
from cse168_raytracer_tpu.utils import checkpoint as jck  # noqa: E402
from cse168_raytracer_tpu.utils import console as jconsole  # noqa: E402
from cse168_raytracer_tpu_torch.config import RenderConfig  # noqa: E402
from cse168_raytracer_tpu_torch.core.sampling import fold_seed  # noqa: E402
from cse168_raytracer_tpu_torch.ops.accel import attach_accel  # noqa: E402
from cse168_raytracer_tpu_torch.render.progressive import \
    render_progressive  # noqa: E402
from cse168_raytracer_tpu_torch.scenes import build  # noqa: E402
from cse168_raytracer_tpu_torch.utils import checkpoint as tck  # noqa: E402
from cse168_raytracer_tpu_torch.utils import console, profiling  # noqa: E402
from test_torch_pathtrace import blocks, rms  # noqa: E402
from test_torch_render import port_inputs  # noqa: E402


def sphere8(spp=4):
    cfg = RenderConfig(width=8, height=8, trace_depth=1, trace_samples=spp,
                       path_tracing=True)
    scene, static, cam, cfg = build("sphere", cfg, device="cpu")
    return scene, static, cam, cfg


def test_render_state_roundtrip(tmp_path):
    p = str(tmp_path / "state.npz")
    accum = torch.arange(12.0).reshape(4, 3)
    tck.save_render_state(p, accum, 7, 42)
    a2, n2, s2 = tck.load_render_state(p, "cpu")
    assert torch.equal(a2, accum) and (n2, s2) == (7, 42)
    assert tck.load_render_state(str(tmp_path / "absent.npz"), "cpu") is None


def test_jax_written_state_raises(tmp_path):
    p = str(tmp_path / "jax_state.npz")
    jck.save_render_state(p, jnp.zeros((4, 3)), 2, jax.random.key(3))
    with pytest.raises(ValueError, match="holds no seed"):
        tck.load_render_state(p, "cpu")


def test_progressive_resume_equals_straight_run(tmp_path):
    """Interrupted after 2 of 4 samples and resumed: the same image as
    an uninterrupted run, bit for bit (tests/test_checkpoint.py's case)."""
    scene, static, cam, cfg = sphere8()
    full = render_progressive(scene, static, cam, cfg, 3)
    ckpt = str(tmp_path / "r.npz")
    render_progressive(scene, static, cam, cfg.replace(trace_samples=2), 3,
                       checkpoint_path=ckpt, checkpoint_every=1)
    assert tck.load_render_state(ckpt, "cpu")[1:] == (2, 3)
    # the file's seed wins over the one passed, as the JAX file's key does
    resumed = render_progressive(scene, static, cam, cfg, 99,
                                 checkpoint_path=ckpt, checkpoint_every=2)
    assert torch.equal(resumed, full)
    assert tck.load_render_state(ckpt, "cpu")[1:] == (4, 3)
    other = render_progressive(scene, static, cam, cfg, 4)
    assert not torch.equal(other, full)


def test_progressive_checkpoint_every_and_on_batch(tmp_path, monkeypatch):
    saves, seen = [], []
    real = tck.save_render_state

    def spy(path, accum, done, seed):
        saves.append(done)
        real(path, accum, done, seed)

    monkeypatch.setattr("cse168_raytracer_tpu_torch.render.progressive."
                        "save_render_state", spy)
    scene, static, cam, cfg = sphere8(spp=5)
    out = render_progressive(scene, static, cam, cfg, 0,
                             checkpoint_path=str(tmp_path / "c.npz"),
                             checkpoint_every=2,
                             on_batch=lambda d, est: seen.append(
                                 (d, est.shape)))
    assert saves == [2, 4, 5]
    assert seen == [(i, (64, 3)) for i in range(1, 6)]
    assert out.shape == (8, 8, 3) and torch.isfinite(out).all()


def test_fold_seed_streams():
    seeds = {fold_seed(s, i) for s in range(4) for i in range(64)}
    assert len(seeds) == 256 and all(0 <= x < 2 ** 63 for x in seeds)
    assert fold_seed(0, 0) == fold_seed(0, 0) and fold_seed(-1, 5) >= 0


def test_progressive_matches_jax_statistically():
    """test_sphere path-traced at 32x32, 16 samples, depth 2: the port's
    8x8 block means against the JAX render_progressive of key 0, within
    3x the RMS between JAX keys 0 and 1 plus 1/255."""
    res = 32
    jcfg = JCfg(width=res, height=res, trace_depth=2, trace_samples=16,
                path_tracing=True)
    js, jst, jcam, _ = j_build("test_sphere", jcfg)
    jsa = j_attach(js)
    ja, jb = (blocks(np.asarray(j_progressive(jsa, jst, jcam, jcfg,
                                              jax.random.key(k))))
              for k in (0, 1))
    ps, pst, pcam = port_inputs(js, jst, jcam)
    cfg = RenderConfig(width=res, height=res, trace_depth=2,
                       trace_samples=16, path_tracing=True)
    hdr = render_progressive(attach_accel(ps), pst, pcam, cfg, 0)
    assert torch.isfinite(hdr).all()
    err, tol = rms(blocks(hdr.numpy()), ja), 3.0 * rms(ja, jb) + 1.0
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("level", ["debug", "info", "warning", "error",
                                   "fatal"])
def test_console_levels_match_jax(level, caplog):
    """Each helper logs the JAX helper's text at its level; fatal raises
    SystemExit(1) after logging."""
    records = {}
    for name, mod in (("miro_tpu", jconsole), ("miro_tpu_torch", console)):
        caplog.clear()
        with caplog.at_level(logging.DEBUG, logger=name):
            fn = getattr(mod, level)
            if level == "fatal":
                with pytest.raises(SystemExit) as e:
                    fn("%d of %s", 3, "x")
                assert e.value.code == 1
            else:
                fn("%d of %s", 3, "x")
        records[name] = [(r.levelno, r.getMessage()) for r in caplog.records
                         if r.name == name]
    assert records["miro_tpu_torch"] == records["miro_tpu"]
    assert records["miro_tpu"][0][1].endswith("3 of x")


def test_console_default_level_hides_debug():
    assert console.logger.level == logging.INFO
    assert not console.logger.isEnabledFor(logging.DEBUG)


def test_profiling_phase_and_spans():
    """The tracer's set-up phases add up by name, wait for a result's
    tensors and reset; its spans reach a sink only while one is open."""
    profiling.reset()
    assert profiling.spans() == {}
    with profiling.phase("a", result=lambda: torch.ones(3)):
        torch.ones(10).sum()
    with profiling.phase("a", result=(torch.zeros(2), {"x": torch.ones(1)}),
                         log=False):
        pass
    with profiling.phase("b"):
        pass
    sp = profiling.spans()
    assert set(sp) == {"a", "b"} and all(v >= 0 for v in sp.values())
    sp["a"] = -1.0      # a copy
    assert profiling.spans()["a"] >= 0
    profiling.reset()
    assert profiling.spans() == {}
    with profiling.span("render.frame"):
        pass
    with profiling.recording() as sink:
        with profiling.span("render.frame"):
            pass
    with profiling.span("render.frame"):
        pass
    assert [s.name for s in sink.spans] == ["render.frame"]
