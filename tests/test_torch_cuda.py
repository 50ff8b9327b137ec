"""The port's CUDA kernels on the card: the wide-tree traversal (the card
walk) with and without its in-kernel counters (K1-K4), the binary-tree traversal in its three modes (K5) and
the block brute force (K6), each against its plain PyTorch version; and
the textured path on the card against the CPU (Worley's tie order, and a
textured, bump-mapped mesh rendered through K1); and the photon path on
the card against the CPU (the gather's radii bit for bit, photon tracing
on the same uniforms); and bilinear patches and a row-sharded render on
the card.

These tests need an NVIDIA GPU and the CUDA toolkit; without a GPU they
skip. They import neither jax nor the JAX package, so they run on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cse168_raytracer_tpu_torch.models.geometry import \
    pack_triangles  # noqa: E402
from cse168_raytracer_tpu_torch.ops import wide_bvh  # noqa: E402
from cse168_raytracer_tpu_torch.utils import profiling  # noqa: E402

pytestmark = pytest.mark.cuda
BIG = 3.0e37


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def clustered_mesh(n_tri, seed):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-2, 2, (12, 3))
    c = centres[rng.integers(0, 12, n_tri)] + rng.normal(0, 0.4, (n_tri, 3))
    v = (c[:, None, :] + rng.normal(0, 0.08, (n_tri, 3, 3))).reshape(-1, 3)
    f = np.arange(n_tri * 3, dtype=np.int64).reshape(n_tri, 3)
    return {"vertices": v.astype(np.float32),
            "normals": rng.normal(0, 1, (n_tri * 3, 3)).astype(np.float32),
            "texcoords": rng.uniform(0, 1, (n_tri * 3, 2)).astype(np.float32),
            "tri_vidx": f, "tri_nidx": f, "tri_tidx": f}


def rays(seed, n, device):
    """Rays into the mesh; some along the axes (the NaN case of the slab
    test) and some dead (tmax < tmin)."""
    rng = np.random.default_rng(seed)
    o = (np.float32([0, 0, -5]) + rng.normal(0, 0.3, (n, 3)))
    d = rng.normal(0, 1.2, (n, 3)) - o
    d[:4] = [[0, 0, 1], [1, 0, 0], [0, 1, 0], [0, 0, 1]]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(3, 12, n)
    tmax[4:8] = -1.0
    t = lambda x: torch.as_tensor(np.float32(x), device=device)
    return t(o), t(d), t(np.zeros(n)), t(tmax)


def tie_mesh(n_base, seed):
    """n_base triangles on a 1/16 grid, each twice as it is and twice
    scaled by 2 about its first vertex: every hit ties, on two lanes of
    one leaf (the copies' operands are equal) and at times across leaves
    (the scaled triangle's t is equal too, its operands scaled by powers
    of two, and its centroid moved)."""
    rng = np.random.default_rng(seed)
    v0 = rng.integers(-32, 33, (n_base, 3)) / 16
    e1 = rng.integers(-4, 5, (n_base, 3)) / 16
    e2 = rng.integers(-4, 5, (n_base, 3)) / 16
    tri = np.stack([v0, v0 + e1, v0 + e2], 1)
    big = np.stack([v0, v0 + 2 * e1, v0 + 2 * e2], 1)
    v = np.concatenate([tri, big, tri, big]).reshape(-1, 3)
    f = np.arange(v.shape[0], dtype=np.int64).reshape(-1, 3)
    return {"vertices": v.astype(np.float32),
            "normals": np.tile(np.float32([[0, 0, 1]]), (v.shape[0], 1)),
            "texcoords": np.zeros((0, 2), np.float32), "tri_vidx": f,
            "tri_nidx": f, "tri_tidx": np.full_like(f, -1)}


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("case", ["ragged", "ties"])
def test_card_walk_equals_walk_plain(cuda, case, width, any_hit):
    """The card walk, with and without counters, against walk_plain
    exactly (t, id, attributes and visit counts): on 4097 rays, the last
    warp holding one, with dead rays inside every warp; and on a mesh
    whose every hit is a tie, where the id must be walk_plain's (the
    first lane, the first leaf visited)."""
    mesh, n = ((clustered_mesh(3000, 23), 4097) if case == "ragged"
               else (tie_mesh(1000, 24), 4096))
    pack = pack_triangles([(mesh, 0)], device=cuda)
    bvh = wide_bvh.build_bvh4_sah(pack, width=width)[1]
    o, d, tmin, tmax = rays(66, n, cuda)
    tmax[3::7] = -1.0
    tp, idp, n_int, n_leaf = wide_bvh.walk_plain(bvh, o, d, tmin, tmax,
                                                 any_hit=any_hit)
    attrp = wide_bvh._gather_attr(bvh, tp, idp.long())
    assert 0 < int((tp < BIG).sum()) < n and int(n_leaf.sum()) > 0
    for stats in (False, True):
        t, ids, attr, nv, lv = wide_bvh._launch(bvh, o, d, tmin, tmax,
                                                any_hit, stats)
        torch.cuda.synchronize()
        assert torch.equal(t, tp)
        if not any_hit:
            assert torch.equal(ids, idp) and torch.equal(attr, attrp)
        if stats:
            assert torch.equal(nv, n_int) and torch.equal(lv, n_leaf)


@pytest.mark.parametrize("width", [4, 8])
def test_kernel_matches_twin_on_card(cuda, width):
    pack = pack_triangles([(clustered_mesh(3000, 16), 0)], device=cuda)
    bvh = wide_bvh.build_bvh4_sah(pack, width=width)[1]
    o, d, tmin, tmax = rays(60, 4096, cuda)
    before = profiling.counts(wide_bvh.LAUNCH)
    t, ids, attr = wide_bvh.closest_hit_triangles(bvh, o, d, tmin, tmax)
    occ = wide_bvh.any_hit_triangles(bvh, o, d, tmin, tmax)
    torch.cuda.synchronize()
    after = profiling.counts(wide_bvh.LAUNCH)
    assert after["closest"] == before["closest"] + 1
    assert after["any"] == before["any"] + 1
    # the plain version walks the same tree in the same order: equal
    for a, b in zip((t, ids, attr), wide_bvh.closest_hit_triangles_plain(
            bvh, o, d, tmin, tmax)):
        assert torch.equal(a, b)
    assert torch.equal(occ, wide_bvh.any_hit_triangles_plain(bvh, o, d,
                                                             tmin, tmax))
    # the brute-force oracle: the same t, ids up to ties
    tp, idp, attrp = wide_bvh.brute_force_triangles(bvh, o, d, tmin, tmax)
    hit = tp < BIG
    assert torch.equal(t < BIG, hit) and 0 < int(hit.sum()) < 4096
    assert torch.equal(t[hit], tp[hit])         # one arithmetic, one order
    same = hit & (ids == idp)
    assert float(same.sum()) / float(hit.sum()) > 0.99
    assert torch.equal(attr[same], attrp[same])
    assert not attr[~hit].any() and not ids[~hit].any()
    assert torch.equal(occ < BIG, hit)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("width", [4, 8])
def test_stats_kernel_matches_walk_plain_on_card(cuda, width, any_hit):
    """Kernel K3: the visit counts equal the plain walk's exactly, and
    counting leaves t, id and attributes as the kernel without it."""
    pack = pack_triangles([(clustered_mesh(3000, 18), 0)], device=cuda)
    bvh = wide_bvh.build_bvh4_sah(pack, width=width)[1]
    o, d, tmin, tmax = rays(62, 4096, cuda)
    mode = "any" if any_hit else "closest"
    before = profiling.counts(wide_bvh.LAUNCH)
    if any_hit:
        t, box, tri = wide_bvh.any_hit_triangles(bvh, o, d, tmin, tmax,
                                                 with_stats=True)
        t0 = wide_bvh.any_hit_triangles(bvh, o, d, tmin, tmax)
    else:
        t, ids, attr, box, tri = wide_bvh.closest_hit_triangles(
            bvh, o, d, tmin, tmax, with_stats=True)
        t0, ids0, attr0 = wide_bvh.closest_hit_triangles(bvh, o, d, tmin,
                                                         tmax)
        assert torch.equal(ids, ids0) and torch.equal(attr, attr0)
    torch.cuda.synchronize()
    key = "stats_" + mode
    assert profiling.counts(wide_bvh.LAUNCH)[key] == before[key] + 1
    assert torch.equal(t, t0)
    tp, idp, n_int, n_leaf = wide_bvh.walk_plain(bvh, o, d, tmin, tmax,
                                                 any_hit=any_hit)
    assert torch.equal(t, tp)
    if not any_hit:
        assert torch.equal(ids, idp)
    assert torch.equal(box, width * n_int)
    assert torch.equal(tri, wide_bvh.K * n_leaf)
    assert int(n_leaf.sum()) > 0


def test_kernel_reports_stack_overflow(cuda):
    pack = pack_triangles([(clustered_mesh(3000, 17), 0)], device=cuda)
    bvh = wide_bvh.build_bvh4_sah(pack, width=4)[1]
    assert bvh.n_nodes > 1
    shallow = dataclasses.replace(bvh, stack_depth=1)
    o, d, tmin, tmax = rays(61, 256, cuda)
    with pytest.raises(RuntimeError, match="stack overflow"):
        wide_bvh.closest_hit_triangles(shallow, o, d, tmin, tmax)


def test_kernel_reports_bad_link(cuda):
    pack = pack_triangles([(clustered_mesh(3000, 17), 0)], device=cuda)
    bvh = wide_bvh.build_bvh4_sah(pack, width=4)[1]
    bad = dataclasses.replace(bvh, links=torch.where(
        bvh.links < 0, bvh.links - 10 ** 6, bvh.links))
    o, d, tmin, tmax = rays(61, 256, cuda)
    with pytest.raises(RuntimeError, match="bad link"):
        wide_bvh.closest_hit_triangles(bad, o, d, tmin, tmax)


def test_card_walk_refuses_a_stack_over_shared_memory(cuda):
    """A stack of more slots than a block's shared memory holds raises
    before the launch."""
    pack = pack_triangles([(clustered_mesh(3000, 17), 0)], device=cuda)
    bvh = wide_bvh.build_bvh4_sah(pack, width=4)[1]
    deep = dataclasses.replace(bvh, stack_depth=455)
    o, d, tmin, tmax = rays(61, 256, cuda)
    before = profiling.counts(wide_bvh.LAUNCH)
    with pytest.raises(ValueError, match="shared memory"):
        wide_bvh.closest_hit_triangles(deep, o, d, tmin, tmax)
    assert profiling.counts(wide_bvh.LAUNCH) == before


@pytest.mark.parametrize("depth", [97, 454])
def test_card_walk_with_stacks_over_48_kb(cuda, depth):
    """Stacks of more than 48 KB a block (the kernel is let take up to
    227 KB) give walk_plain's answers, on two launches each."""
    pack = pack_triangles([(clustered_mesh(3000, 17), 0)], device=cuda)
    bvh = wide_bvh.build_bvh4_sah(pack, width=4)[1]
    deep = dataclasses.replace(bvh, stack_depth=depth)
    lib = wide_bvh._kernel_lib()
    assert wide_bvh._stack_smem_bytes(lib, depth) > 48 * 1024
    o, d, tmin, tmax = rays(61, 1000, cuda)
    tp, idp, _, _ = wide_bvh.walk_plain(bvh, o, d, tmin, tmax)
    for _ in range(2):
        t, ids, _ = wide_bvh.closest_hit_triangles(deep, o, d, tmin, tmax)
        assert torch.equal(t, tp) and torch.equal(ids, idp)


@pytest.mark.parametrize("any_hit", [False, True])
def test_binary_kernel_matches_plain_on_card(cuda, any_hit):
    """Kernel K5 in its three modes (closest, any hit, with counters)
    against walk_binary_plain on the same rays: t, id and counts equal."""
    from cse168_raytracer_tpu_torch.ops import binary_bvh
    pack = pack_triangles([(clustered_mesh(3000, 19), 0)], device=cuda)
    bvh = binary_bvh.build_binary_bvh_sah(pack)[1]
    o, d, tmin, tmax = rays(63, 4096, cuda)
    mode = "any" if any_hit else "closest"
    before = profiling.counts(binary_bvh.LAUNCH)
    kern = (binary_bvh.any_hit_triangles if any_hit
            else binary_bvh.closest_hit_triangles)
    got = kern(bvh, o, d, tmin, tmax)
    got = got if isinstance(got, tuple) else (got,)
    *counted, box, tri = kern(bvh, o, d, tmin, tmax, with_stats=True)
    torch.cuda.synchronize()
    after = profiling.counts(binary_bvh.LAUNCH)
    assert after[mode] == before[mode] + 1
    assert after["stats_" + mode] == before["stats_" + mode] + 1
    tp, idp, n_int, n_leaf = binary_bvh.walk_binary_plain(
        bvh, o, d, tmin, tmax, any_hit=any_hit)
    for a, b, c in zip(got, counted, (tp, idp)):
        assert torch.equal(a, c) and torch.equal(b, c)
    assert torch.equal(box, 2 * n_int)
    assert torch.equal(tri, binary_bvh.K * n_leaf)
    hit = tp < BIG
    assert 0 < int(hit.sum()) < 4096 and int(n_leaf.sum()) > 0
    # the wide tree's kernel finds the same t (one leaf test, one order)
    wt = wide_bvh.brute_force_triangles(
        wide_bvh.build_bvh4_sah(pack)[1], o, d, tmin, tmax)[0]
    assert torch.equal(wt < BIG, hit)
    if not any_hit:
        assert torch.equal(wt[hit], tp[hit])


def test_binary_kernel_reports_stack_overflow(cuda):
    from cse168_raytracer_tpu_torch.ops import binary_bvh
    pack = pack_triangles([(clustered_mesh(3000, 17), 0)], device=cuda)
    bvh = binary_bvh.build_binary_bvh_sah(pack)[1]
    assert bvh.n_nodes > 1
    shallow = dataclasses.replace(bvh, stack_depth=1)
    o, d, tmin, tmax = rays(64, 256, cuda)
    with pytest.raises(RuntimeError, match="stack overflow"):
        binary_bvh.closest_hit_triangles(shallow, o, d, tmin, tmax)


@pytest.mark.parametrize("depth", [60, 220])
def test_binary_kernel_with_stacks_over_48_kb(cuda, depth):
    """K5's card walk with 60 and 220 two-word stack slots a thread
    (61,440 and 225,280 bytes of shared memory a block): the launch is
    let take them, and the outputs equal walk_binary_plain's."""
    from cse168_raytracer_tpu_torch.ops import binary_bvh
    pack = pack_triangles([(clustered_mesh(3000, 21), 0)], device=cuda)
    bvh = dataclasses.replace(binary_bvh.build_binary_bvh_sah(pack)[1],
                              stack_depth=depth)
    o, d, tmin, tmax = rays(66, 2048, cuda)
    t, ids, box, tri = binary_bvh.closest_hit_triangles(
        bvh, o, d, tmin, tmax, with_stats=True)
    tp, idp, n_int, n_leaf = binary_bvh.walk_binary_plain(bvh, o, d, tmin,
                                                          tmax)
    assert torch.equal(t, tp) and torch.equal(ids, idp)
    assert torch.equal(box, 2 * n_int) and torch.equal(tri, binary_bvh.K
                                                       * n_leaf)
    with pytest.raises(ValueError, match="shared memory"):
        binary_bvh.closest_hit_triangles(
            dataclasses.replace(bvh, stack_depth=228), o, d, tmin, tmax)


def test_block_kernel_matches_plain_on_card(cuda):
    """Kernel K6 against its plain version: t, id and the (tile, block)
    pairs that passed the cull equal, on a ray count that leaves a ragged
    last tile; its t equal to the brute force's."""
    from cse168_raytracer_tpu_torch.ops import accel, tri_blocks
    pack = pack_triangles([(clustered_mesh(3000, 20), 0)], block=256,
                          device=cuda)
    a = {k: getattr(pack, k).cpu().numpy() for k in ("v0", "e1", "e2",
                                                     "valid")}
    pack = accel.reorder_pack(pack, accel.morton_order(
        a["v0"], a["e1"], a["e2"], a["valid"]))
    blocks = tri_blocks.build_tri_blocks(pack)
    o, d, tmin, tmax = rays(65, 4000, cuda)
    before = profiling.counts(tri_blocks.LAUNCH)["closest"]
    t, ids = tri_blocks.closest_hit(blocks, o, d, tmin, tmax)
    torch.cuda.synchronize()
    assert profiling.counts(tri_blocks.LAUNCH)["closest"] == before + 1
    tp, idp, pairs = tri_blocks.closest_hit_plain(blocks, o, d, tmin, tmax,
                                                  count_pairs=True)
    assert torch.equal(t, tp) and torch.equal(ids, idp) and pairs > 0
    # the tiles' passing blocks, as the kernel counts them
    assert int(tri_blocks._launch(blocks, o, d, tmin, tmax,
                                  count_pairs=True)[2].sum()) == pairs
    hit = t < BIG
    assert 0 < int(hit.sum()) < 4000
    wt = wide_bvh.brute_force_triangles(
        wide_bvh.build_bvh4_sah(pack)[1], o, d, tmin, tmax)[0]
    # the block cull is not widened: a hit just past a block's box may be
    # culled where no other ray of the tile enters it
    both = (wt < BIG) & hit
    assert float((wt < BIG).eq(hit).float().mean()) >= 0.999
    assert torch.equal(wt[both], t[both])


def test_worley2_ids_card_match_cpu_on_a_tie(cuda):
    """worley2 ranking every slot of its 9 cells (max_order 45), so the
    masked slots, which all hold 999999.9, tie: the card's ids and deltas
    equal the CPU's (lax.top_k's order, the lowest slot first), and F is
    within two ulps (rtol 2.5e-7; the card's sqrt of a sum may round
    apart from the CPU's, 572 of 184,320 values by one ulp, 9.5e-7 at
    most, on an H100)."""
    from cse168_raytracer_tpu_torch.core.noise import worley2
    p = np.random.default_rng(0).uniform(-40, 40, (4096, 2)).astype(
        np.float32)
    f_card, d_card, i_card = worley2(torch.as_tensor(p, device=cuda), 45)
    f, d, i = worley2(torch.as_tensor(p), 45)
    assert (f > 2000).any()
    assert torch.equal(i_card.cpu(), i)
    torch.testing.assert_close(f_card.cpu(), f, rtol=2.5e-7, atol=0)
    assert torch.equal(d_card.cpu(), d)


def test_textured_scene_card_matches_cpu(cuda, tmp_path):
    """chip_smoke.py phase 10(b)'s scene (sponza_proxy's mesh read back
    from an OBJ, stone with its bump map, stem, cellular and cloud
    materials, a glass sphere, an evaluated cloud environment) at 64x64
    and the registered depth 10, card against CPU, by
    tests/test_golden.py's bar on the tonemapped bytes: at least 99.9%
    within +-2 and a mean |difference| of at most 0.05. The bump map's
    central difference magnifies the ulps by which the card's pow and
    exp may differ from the CPU's, so the bar is per pixel, not rtol
    1e-5."""
    from chip_smoke import byte_diff, textured_scene, write_proxy_obj
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.models.obj import load_obj
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    path = str(tmp_path / "proxy.obj")
    write_proxy_obj(path)
    mesh = load_obj(path)
    cfg = RenderConfig(width=64, height=64)
    hdrs = []
    with torch.no_grad():
        for device in (cuda, torch.device("cpu")):
            scene, static, cam = textured_scene(mesh, device)
            assert static.any_bump and static.any_refractive
            hdrs.append(render_hdr(attach_accel(scene), static, cam,
                                   cfg)[0].cpu())
    assert torch.isfinite(hdrs[0]).all() and hdrs[0].max() > hdrs[0].min()
    diff = byte_diff(*hdrs)
    assert np.mean(diff <= 2) >= 0.999 and diff.mean() <= 0.05, (
        np.mean(diff <= 2), diff.mean(), diff.max())


def small_photon_maps():
    """chip_smoke.py phase 11's stand-in scene on the CPU and 4,000 +
    4,000 photons of it (max_per_cell 32, as there)."""
    from chip_smoke import photon_scene
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.ops.photon import build_photon_maps
    scene, static, cam = photon_scene(torch.device("cpu"))
    cfg = RenderConfig(photons_per_light=4000, caustic_photons_per_light=4000,
                       photon_grid_max_per_cell=32)
    maps = build_photon_maps(scene, static, cfg,
                             torch.Generator().manual_seed(7))
    return scene, static, cam, maps


def test_photon_gather_card_matches_cpu(cuda):
    """The gather on the card and on the CPU, same maps and points
    (phase 11(b) at a small size): r'^2 of both levels and the level
    choice bit for bit, the irradiance within rtol 1e-5 (the order of
    the final sum may differ)."""
    from chip_smoke import diffuse_points
    from cse168_raytracer_tpu_torch.core.vecmath import safe_normalize
    from cse168_raytracer_tpu_torch.ops import photon as ph
    scene, static, cam, maps = small_photon_maps()
    p, n = diffuse_points(scene, static, cam, 2000, res=64)
    n = safe_normalize(n)
    for name in ("global_map", "caustic_map"):
        grid = getattr(maps, name)
        args = (grid.power, grid.coarse.power, 500)
        cpu_out = ph.gather_levels(grid, p, n, *args)
        g = grid.to(cuda)
        card_out = ph.gather_levels(g, p.to(cuda), n.to(cuda), g.power,
                                    g.coarse.power, 500)
        for a, b in zip(card_out[1:], cpu_out[1:]):
            assert torch.equal(a.cpu(), b)
        assert cpu_out[0].abs().sum() > 0
        torch.testing.assert_close(card_out[0].cpu(), cpu_out[0], rtol=1e-5,
                                   atol=0)


def test_photon_trace_card_matches_cpu(cuda):
    """trace_photon_batch on the card and on the CPU with the same
    uniforms (phase 11(c) at 8,192 photons), global and caustic, at
    chip_smoke's bars: masks on TRACE_MASK_AGREE of the slots, the
    jointly stored slots' positions, directions and powers within
    rtol/atol 1e-4 on TRACE_CLOSE of them."""
    from chip_smoke import TRACE_CLOSE, TRACE_MASK_AGREE, photon_scene
    from cse168_raytracer_tpu_torch.ops import photon as ph
    cpu_scene, static, _, _ = small_photon_maps()
    card_scene = photon_scene(cuda)[0]
    for caustic in (False, True):
        u = ph.draw_photon_uniforms(torch.Generator().manual_seed(int(caustic)),
                                    8192, 5, False)
        u_card = ph.PhotonUniforms(**{
            f.name: None if getattr(u, f.name) is None
            else getattr(u, f.name).to(cuda) for f in dataclasses.fields(u)})
        a = ph.trace_photon_batch(card_scene, static, 0, caustic, False,
                                  u_card)
        b = ph.trace_photon_batch(cpu_scene, static, 0, caustic, False, u)
        am = a.mask.cpu()
        assert float((am == b.mask).float().mean()) >= TRACE_MASK_AGREE
        both = am & b.mask
        assert both.sum() > 100
        for f in ("pos", "dir", "power"):
            ok = torch.isclose(getattr(a, f).cpu()[both],
                               getattr(b, f)[both], rtol=1e-4,
                               atol=1e-4).all(-1)
            assert float(ok.float().mean()) >= TRACE_CLOSE, f


def random_patches(n, seed):
    """n curved bilinear patches, corners jittered off a grid of unit
    squares in the y = 0 plane."""
    rng = np.random.default_rng(seed)
    base = np.stack(np.meshgrid(np.arange(4), np.arange(n // 4),
                                indexing="ij"), -1).reshape(-1, 2)[:n] - 2.0
    corners = []
    for du, dv in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xz = base + [du, dv]
        corners.append(np.stack([xz[:, 0], rng.uniform(-0.4, 0.4, n),
                                 xz[:, 1]], -1).astype(np.float32))
    return corners


def test_blpatch_intersection_card_matches_cpu(cuda):
    """intersect_blpatches on 65,536 rays x 16 patches: the card's hits
    and ids equal the CPU's, t within rtol 1e-5."""
    from cse168_raytracer_tpu_torch.models.geometry import make_blpatch_pool
    from cse168_raytracer_tpu_torch.ops.intersect import intersect_blpatches
    corners = random_patches(16, 0)
    rng = np.random.default_rng(1)
    n = 65_536
    o = rng.uniform([-3, 2, -3], [3, 4, 3], (n, 3)).astype(np.float32)
    aim = rng.uniform([-2.5, -0.5, -2.5], [2.5, 0.5, 2.5], (n, 3))
    d = ((aim - o) / np.linalg.norm(aim - o, axis=1,
                                    keepdims=True)).astype(np.float32)
    hits = []
    for dev in ("cpu", cuda):
        pool = make_blpatch_pool(*corners, np.arange(16), device=dev)
        hits.append(intersect_blpatches(pool, torch.as_tensor(o, device=dev),
                                        torch.as_tensor(d, device=dev),
                                        0.0, 1e12))
    cpu, card = hits
    assert torch.equal(card.hit.cpu(), cpu.hit) and cpu.hit.float().mean() > 0.3
    assert torch.equal(card.prim_id.cpu()[cpu.hit], cpu.prim_id[cpu.hit])
    torch.testing.assert_close(card.t.cpu(), cpu.t, rtol=1e-5, atol=0)


def test_sharded_render_card_equals_render_hdr(cuda):
    """A 2-shard render_hdr_sharded of test_sphere on the card equals the
    card's render_hdr (Whitted: rtol 1e-5)."""
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.parallel.sharding import (
        make_mesh, render_hdr_sharded)
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    from cse168_raytracer_tpu_torch.scenes import build
    cfg = RenderConfig(width=64, height=64, trace_depth=4)
    scene, static, cam, cfg = build("test_sphere", cfg, device=cuda)
    with torch.no_grad():
        ref, _ = render_hdr(scene, static, cam, cfg)
        shd = render_hdr_sharded(scene, static, cam, cfg,
                                 make_mesh(2, cuda))
    assert shd.device.type == "cuda" and float(ref.max()) > 0
    torch.testing.assert_close(shd, ref, rtol=1e-5, atol=1e-6)


def test_sqrt_rn_card_rounds_to_nearest(cuda):
    """sqrt_rn on the card (torch.sqrt) on all 2^31 non-negative float32
    inputs, in chunks of 2^24: each root rounded to nearest; and its
    gradient, torch.sqrt's on the card, equal to the CPU route's."""
    from chip_smoke import exhaustive_root
    from cse168_raytracer_tpu_torch.core.vecmath import sqrt_rn
    assert exhaustive_root(sqrt_rn, cuda, chunk=1 << 24) == 0
    x = torch.rand(1 << 20, generator=torch.Generator().manual_seed(0)) + 0.5
    g = torch.rand(1 << 20, generator=torch.Generator().manual_seed(1))
    grads = []
    for dev in ("cpu", cuda):
        a = x.to(dev).detach().requires_grad_(True)
        sqrt_rn(a).backward(g.to(dev))
        grads.append(a.grad.cpu())
    assert torch.equal(*grads)


def test_device_stable_ops_card_equal_cpu(cuda):
    """normalize on 2^20 vectors, div_scalar by 480 and by 2 pi, and
    add_in_lane_order on repeated pixels: the card's bits are the
    CPU's."""
    from cse168_raytracer_tpu_torch.core.vecmath import div_scalar, normalize
    from cse168_raytracer_tpu_torch.render.integrator import \
        add_in_lane_order
    g = torch.Generator().manual_seed(2)
    v = torch.randn((1 << 20, 3), generator=g) * torch.exp(
        4 * torch.randn((1 << 20, 1), generator=g))
    assert torch.equal(normalize(v.to(cuda)).cpu(), normalize(v))
    for c in (480.0, 2 * np.pi):
        assert torch.equal(div_scalar(v.to(cuda), c).cpu(), div_scalar(v, c))
    pixel = torch.randint(0, 1 << 16, (1 << 18,), generator=g)
    alive = torch.rand(1 << 18, generator=g) < 0.8
    terms = torch.where(alive[:, None], v[:1 << 18].abs(), 0.0)
    base = torch.rand((1 << 16, 3), generator=g)
    want = base.index_add(0, pixel, terms)
    got = add_in_lane_order(*(x.to(cuda) for x in (base, pixel, terms,
                                                    alive)))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("name", ["sphere", "mixed"])
def test_whitted_64_card_equals_cpu(cuda, name):
    """The Whitted forward at 64x64, depth 4, on the card and on the CPU:
    equal by torch.equal (the mixed scene's Fresnel splits put two terms
    on a pixel in one level)."""
    from chip_smoke import mixed_scene
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    from cse168_raytracer_tpu_torch.scenes import build
    cfg = RenderConfig(width=64, height=64, trace_depth=4)
    hdrs = []
    for dev in (torch.device("cpu"), cuda):
        if name == "mixed":
            scene, static, cam = mixed_scene(dev)
        else:
            scene, static, cam, _ = build(name, cfg, device=dev)
        with torch.no_grad():
            hdrs.append(render_hdr(attach_accel(scene), static, cam,
                                   cfg)[0].cpu())
    assert float(hdrs[0].max()) > 0 and torch.equal(*hdrs)


def test_segment_sum_kernel_equals_plain_on_card(cuda):
    """csrc/segment_sum.cu against segment_sum_plain by torch.equal, and
    against itself over two runs: runs of 1 to 3,000 terms, empty rows,
    -0.0 and subnormal terms, 1, 3 and 29 columns, and a run of 2^21
    terms (more than 1,024 tiles: the partials' second level); with one
    row the call runs no sort."""
    from cse168_raytracer_tpu_torch.ops import segment_sum as ss
    rng = np.random.default_rng(3)
    ids = np.concatenate([np.zeros(3000, np.int64), np.full(1025, 1),
                          np.full(1024, 3), [6], rng.integers(8, 64, 900)])
    rng.shuffle(ids)
    cases = []
    for cols in (1, 3, 29):
        v = (rng.normal(0, 1, (ids.size, cols))
             * np.exp(rng.normal(0, 6, (ids.size, cols)))).astype(np.float32)
        v.reshape(-1)[::11] = -0.0
        v.reshape(-1)[5::13] = np.float32(1e-40)
        cases.append((v, ids, 70))
    cases.append((rng.normal(0, 1, ((1 << 21), 1)).astype(np.float32),
                  np.zeros(1 << 21, np.int64), 2))
    for v, i, n_rows in cases:
        tv, ti = torch.as_tensor(v), torch.as_tensor(i)
        want = ss.segment_sum_plain(tv, ti, n_rows)
        before = profiling.counts(ss.LAUNCH)
        a = ss.segment_sum(tv.to(cuda), ti.to(cuda), n_rows)
        b = ss.segment_sum(tv.to(cuda), ti.to(cuda), n_rows)
        assert profiling.counts(ss.LAUNCH)["sums"] == before["sums"] + 2
        # one row: no sort
        assert profiling.counts(ss.LAUNCH)["sort"] == before["sort"] + (
            2 if n_rows > 1 else 0)
        assert torch.equal(a.cpu(), want) and torch.equal(a, b)


@pytest.mark.parametrize("n_rows", [2, 256, 257, 2000, 270_336,
                                    (1 << 19) + 1])
def test_segment_sum_sort_is_torch_sort_on_card(cuda, n_rows):
    """The kernel's radix sort over ceil(log2 n_rows) bits gives
    torch.sort(stable=True)'s permutation (1, 8, 9, 11, 19 and 20 bits),
    on random ids, on descending ones and with every id the last row."""
    from cse168_raytracer_tpu_torch.ops import segment_sum as ss
    rng = np.random.default_rng(n_rows)
    n = 300_000
    for ids in (rng.integers(0, n_rows, n),
                np.sort(rng.integers(0, n_rows, n))[::-1].copy(),
                np.full(n, n_rows - 1)):
        ti = torch.as_tensor(ids).to(cuda)
        got = ss.stable_order(ti, n_rows)
        assert got.dtype == torch.int32
        assert torch.equal(got.long(), torch.sort(ti, stable=True)[1])


@pytest.mark.parametrize("name", ["sphere", "mixed"])
def test_kd_grad_64_card_equals_cpu(cuda, name):
    """The kd gradient of sum(hdr) at 64x64, depth 4, on the card and on
    the CPU: equal by torch.equal (the kd lookups' backward is
    ops/segment_sum.py on both)."""
    from chip_smoke import fwd_bwd, mixed_scene
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    from cse168_raytracer_tpu_torch.scenes import build
    cfg = RenderConfig(width=64, height=64, trace_depth=4)
    grads = []
    for dev in (torch.device("cpu"), cuda):
        if name == "mixed":
            scene, static, cam = mixed_scene(dev)
        else:
            scene, static, cam, _ = build(name, cfg, device=dev)
        grads.append(fwd_bwd(attach_accel(scene), static, cam, cfg)[1].cpu())
    assert float(grads[0].abs().sum()) > 0 and torch.equal(*grads)


@pytest.mark.parametrize("name,mode", [("sponza_proxy", "fit"),
                                       ("photon_box", "whitted")])
def test_skipped_pools_give_the_dense_bits_on_card(cuda, name, mode):
    """At 512x512 on the card, a lit sponza_proxy step (image, kd and v0
    gradients of sum(hdr)) and a photon_box Whitted frame: skipping the
    empty sphere and plane pools gives the bits of scanning them
    (tests/test_torch_pool_skip.py holds it on the CPU)."""
    from test_torch_pool_skip import (assert_same_bits, dense, render,
                                      scene_case)
    scene, static, cam, cfg = scene_case(name, cuda, res=512)
    with profiling.recording() as sink:
        got = render(scene, static, cam, cfg, mode)
    assert not any(k.startswith("pool.scanned.") for k in sink.counts)
    assert sink.counts["pool.skipped.spheres"] > 0
    assert_same_bits(got, render(dense(scene), static, cam, cfg, mode))
