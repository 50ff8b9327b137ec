"""The port's CUDA kernels on the card: the wide-tree traversal (the card
walk, and the per-ray kernel it replaced) with and without its in-kernel
counters (K1-K4), the binary-tree traversal in its three modes (K5) and
the block brute force (K6), each against its plain PyTorch version.

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
    """The card walk and the per-ray kernel it replaced, each with and
    without counters, against walk_plain exactly (t, id, attributes and
    visit counts): on 4097 rays, the last warp holding one, with dead
    rays inside every warp; and on a mesh whose every hit is a tie,
    where the id must be walk_plain's (the first lane, the first leaf
    visited)."""
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
    for launch in (wide_bvh._launch, wide_bvh._launch_per_ray):
        for stats in (False, True):
            t, ids, attr, nv, lv = launch(bvh, o, d, tmin, tmax, any_hit,
                                          stats)
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
    before = dict(wide_bvh.LAUNCHES)
    t, ids, attr = wide_bvh.closest_hit_triangles(bvh, o, d, tmin, tmax)
    occ = wide_bvh.any_hit_triangles(bvh, o, d, tmin, tmax)
    torch.cuda.synchronize()
    assert wide_bvh.LAUNCHES["closest"] == before["closest"] + 1
    assert wide_bvh.LAUNCHES["any"] == before["any"] + 1
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
    before = dict(wide_bvh.LAUNCHES)
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
    assert wide_bvh.LAUNCHES["stats_" + mode] == before["stats_" + mode] + 1
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
    before = dict(wide_bvh.LAUNCHES)
    with pytest.raises(ValueError, match="shared memory"):
        wide_bvh.closest_hit_triangles(deep, o, d, tmin, tmax)
    assert wide_bvh.LAUNCHES == before


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
    before = dict(binary_bvh.LAUNCHES)
    kern = (binary_bvh.any_hit_triangles if any_hit
            else binary_bvh.closest_hit_triangles)
    got = kern(bvh, o, d, tmin, tmax)
    got = got if isinstance(got, tuple) else (got,)
    *counted, box, tri = kern(bvh, o, d, tmin, tmax, with_stats=True)
    torch.cuda.synchronize()
    assert binary_bvh.LAUNCHES[mode] == before[mode] + 1
    assert binary_bvh.LAUNCHES["stats_" + mode] == before["stats_" + mode] + 1
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


def test_block_kernel_matches_plain_on_card(cuda):
    """Kernel K6 against its plain version: t and id equal, on a ray
    count that leaves a ragged last tile; its t equal to the brute
    force's."""
    from cse168_raytracer_tpu_torch.ops import accel, tri_blocks
    pack = pack_triangles([(clustered_mesh(3000, 20), 0)], block=256,
                          device=cuda)
    a = {k: getattr(pack, k).cpu().numpy() for k in ("v0", "e1", "e2",
                                                     "valid")}
    pack = accel.reorder_pack(pack, accel.morton_order(
        a["v0"], a["e1"], a["e2"], a["valid"]))
    blocks = tri_blocks.build_tri_blocks(pack)
    o, d, tmin, tmax = rays(65, 4000, cuda)
    before = tri_blocks.LAUNCHES["closest"]
    t, ids = tri_blocks.closest_hit(blocks, o, d, tmin, tmax)
    torch.cuda.synchronize()
    assert tri_blocks.LAUNCHES["closest"] == before + 1
    tp, idp, pairs = tri_blocks.closest_hit_plain(blocks, o, d, tmin, tmax,
                                                  count_pairs=True)
    assert torch.equal(t, tp) and torch.equal(ids, idp) and pairs > 0
    hit = t < BIG
    assert 0 < int(hit.sum()) < 4000
    wt = wide_bvh.brute_force_triangles(
        wide_bvh.build_bvh4_sah(pack)[1], o, d, tmin, tmax)[0]
    # the block cull is not widened: a hit just past a block's box may be
    # culled where no other ray of the tile enters it
    both = (wt < BIG) & hit
    assert float((wt < BIG).eq(hit).float().mean()) >= 0.999
    assert torch.equal(wt[both], t[both])
