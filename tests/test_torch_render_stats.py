"""The traversal counters (kernel K3) through whole renders, on the CPU.

With cfg.collect_stats the port's render leaves its image as it is and
sums, into RenderStats.box_tests / tri_tests, the per-ray counts of
every traversal the render makes: primary, secondary and shadow rays, in
the any-hit and the closest-hit shadow modes. On CPU tensors those
counts are ops/wide_bvh.walk_plain's. Against the JAX package, each
traversal of a sponza_proxy render is run through the Pallas kernel's
with_stats mode one ray per 256-lane tile (the JAX render itself bills a
tile's visits to all 256 of its rays, so its totals are not per ray),
at the bars of tests/test_torch_stats.py."""

import pytest

torch = pytest.importorskip("torch")

from cse168_raytracer_tpu.config import RenderConfig as JCfg  # noqa: E402
from cse168_raytracer_tpu.models.lights import \
    make_light_table as j_lights  # noqa: E402
from cse168_raytracer_tpu.ops import pallas_bvh as jpb  # noqa: E402
from cse168_raytracer_tpu.scenes import build as j_build  # noqa: E402
from cse168_raytracer_tpu_torch.config import RenderConfig  # noqa: E402
from cse168_raytracer_tpu_torch.ops import accel as taccel  # noqa: E402
from cse168_raytracer_tpu_torch.ops import wide_bvh as twb  # noqa: E402
from cse168_raytracer_tpu_torch.render.integrator import \
    render_hdr  # noqa: E402
from test_torch_render import jax_mixed_scene, port_inputs  # noqa: E402
from test_torch_stats import assert_counts_agree, pallas_counts  # noqa: E402
from test_torch_traverse import ensure_native  # noqa: E402

LIT_LIGHT = [dict(kind=0, position=(0.0, 8.0, 0.0), color=(1, 1, 1),
                  wattage=200.0)]


@pytest.fixture
def traversals(monkeypatch):
    """Every wide-tree traversal of the scene-level hit queries, recorded
    with its inputs and outputs."""
    calls = []
    for mode in ("closest", "any"):
        real = getattr(twb, f"{mode}_hit_triangles")

        def record(bvh, o, d, tmin, tmax, with_stats=False, _real=real,
                   _mode=mode):
            out = _real(bvh, o, d, tmin, tmax, with_stats)
            n = o.shape[0]
            bound = lambda x: torch.as_tensor(x, dtype=torch.float32).expand(
                n).clone()
            calls.append(dict(any_hit=_mode == "any", with_stats=with_stats,
                              rays=(o.detach().clone(), d.detach().clone(),
                                    bound(tmin), bound(tmax)),
                              out=out))
            return out

        monkeypatch.setattr(twb, f"{mode}_hit_triangles", record)
    return calls


def scene(name, res):
    if name == "mixed":
        js, jst, jcam = jax_mixed_scene()
    else:
        js, jst, jcam, _ = j_build("sponza_proxy", JCfg(width=res,
                                                        height=res))
        js = js.replace(lights=j_lights(LIT_LIGHT))
    ps, pst, pcam = port_inputs(js, jst, jcam)
    return js, taccel.attach_accel(ps), pst, pcam


@pytest.mark.parametrize("name,cfg_kw", [
    ("mixed", dict(path_tracing=True, trace_samples=2, trace_depth=4)),
    ("sponza_lit", dict(trace_depth=4))])
def test_counters_sum_every_traversal(traversals, name, cfg_kw):
    _, ps, pst, pcam = scene(name, 16)
    cfg = RenderConfig(width=16, height=16, **cfg_kw)
    with torch.no_grad():
        plain_img, plain_stats = render_hdr(ps, pst, pcam, cfg)
        traversals.clear()
        img, stats = render_hdr(ps, pst, pcam,
                                cfg.replace(collect_stats=True))
    assert torch.equal(img, plain_img)            # bit for bit
    for f in ("primary_rays", "secondary_rays", "shadow_rays",
              "dropped_rays"):
        assert int(getattr(stats, f)) == int(getattr(plain_stats, f))
    assert int(plain_stats.box_tests) == int(plain_stats.tri_tests) == 0
    assert traversals and all(c["with_stats"] for c in traversals)
    modes = {c["any_hit"] for c in traversals}
    # refractive scenes shade with closest-hit shadow rays
    assert modes == ({False} if name == "mixed" else {False, True})
    box = tri = 0
    for c in traversals:
        t, _, n_int, n_leaf = twb.walk_plain(ps.accel, *c["rays"],
                                             any_hit=c["any_hit"])
        assert torch.equal(c["out"][-2], ps.accel.width * n_int)
        assert torch.equal(c["out"][-1], twb.K * n_leaf)
        box += int(c["out"][-2].sum())
        tri += int(c["out"][-1].sum())
    assert box == int(stats.box_tests) > 0
    assert tri == int(stats.tri_tests) > 0
    if name == "mixed":
        assert int(stats.secondary_rays) > 0


def test_render_counters_against_pallas(traversals):
    """sponza_proxy lit at 16x16: the primary (closest-hit) and shadow
    (any-hit) traversals of the port's render, each ray also walked by
    the Pallas kernel alone in its tile."""
    ensure_native()
    js, ps, pst, pcam = scene("sponza_lit", 16)
    jbvh = jpb.build_pallas_bvh4_sah(js.tris)[1]
    assert (jbvh.n_nodes, jbvh.n_leaves) == (ps.accel.n_nodes,
                                             ps.accel.n_leaves)
    with torch.no_grad():
        _, stats = render_hdr(ps, pst, pcam, RenderConfig(
            width=16, height=16, trace_depth=4, collect_stats=True))
    assert [c["any_hit"] for c in traversals] == [False, True]
    for c in traversals:
        o, d, tmin, tmax = (x.numpy() for x in c["rays"])
        out = [x.numpy() for x in c["out"]]
        case = "sponza_proxy " + ("shadow" if c["any_hit"] else "primary")
        assert_counts_agree(case, 4, c["any_hit"], out[0], out[-2], out[-1],
                            *pallas_counts(jbvh, o, d, tmin, tmax,
                                           c["any_hit"]))
    assert int(stats.box_tests) == sum(int(c["out"][-2].sum())
                                       for c in traversals)
