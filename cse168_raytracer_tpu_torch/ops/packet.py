"""Tile-packet BVH walk (attach_accel kind "packet").

Counterpart of cse168_raytracer_tpu/ops/packet.py:85-306, plain PyTorch
as there: rays are split into tiles of `tile` consecutive rays (callers
give a coherent order), each tile walks the implicit LBVH of ops/bvh.py
with ONE shared stack of (node, entry t), and every tile advances by one
pop per step. A node is visited when some ray of the tile may hit it
before the tile's worst current best (the conservative tile-level
cull); an internal visit pushes the children far then near by the
tile's smallest entry t; a leaf visit tests every ray of the tile
against the leaf's K-triangle packet, whose Pluecker operands are
sliced from the pack (ops/pluecker.py's sums); an any-hit tile stops
once all its live rays are occluded. Inputs are detached.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cse168_raytracer_tpu_torch.config import MIRO_TMAX
from cse168_raytracer_tpu_torch.core.vecmath import cross
from cse168_raytracer_tpu_torch.models.geometry import TrianglePack
from cse168_raytracer_tpu_torch.ops.bvh import (TraversalStats, _build_cbox,
                                                _leaf_boxes, _slab_enter)
from cse168_raytracer_tpu_torch.ops.intersect import (PRIM_TRI, _BIG, Hit,
                                                      _hit,
                                                      _occluded_by_pools,
                                                      _then_pools, ray_bounds)
from cse168_raytracer_tpu_torch.ops.pluecker import triangle_t


@dataclasses.dataclass
class PacketAccel:
    """Implicit BVH with K-triangle leaf packets."""
    cbox: torch.Tensor     # (max(P-1,1), 12) f32 [lo_L, hi_L, lo_R, hi_R]
    leaf_w6: torch.Tensor  # (L, 6, 3K) f32 Pluecker operands, [b g den]
    #                        interleaved per triangle
    leaf_w4: torch.Tensor  # (L, 4, K) f32 t-numerator operands
    n_internal: int
    n_leaves: int
    leaf_size: int
    stack_depth: int
    tile: int              # rays per traversal tile


def build_packet_accel(pack: TrianglePack, leaf_size: int = 32,
                       tile: int = 128) -> PacketAccel:
    """Build for a Morton-ORDERED pack (see ops/accel.attach_accel)."""
    leaf_lo, leaf_hi, n_leaves = _leaf_boxes(pack, leaf_size)
    cbox, n_internal, stack_depth = _build_cbox(leaf_lo, leaf_hi)
    k = leaf_size
    leaf_w6 = pack.w6.reshape(6, n_leaves, k * 3).permute(1, 0, 2)
    leaf_w4 = pack.w4.reshape(4, n_leaves, k).permute(1, 0, 2)
    return PacketAccel(
        cbox=torch.as_tensor(np.asarray(cbox, np.float32),
                             device=pack.v0.device),
        leaf_w6=leaf_w6.contiguous(), leaf_w4=leaf_w4.contiguous(),
        n_internal=int(n_internal), n_leaves=int(n_leaves),
        leaf_size=int(leaf_size), stack_depth=int(stack_depth),
        tile=int(tile))


@torch.no_grad()
def packet_closest_hit_triangles(accel: PacketAccel, o, d, tmin, tmax,
                                 collect_stats: bool = False,
                                 any_hit: bool = False):
    """Tile-packet walk. Returns (t (N,), _BIG on a miss; id (N,) int32 =
    Morton pack row); collect_stats appends TraversalStats, counting K
    triangle tests for every ray of a tile per visited leaf."""
    o, d = o.detach(), d.detach()
    n, t, k = o.shape[0], accel.tile, accel.leaf_size
    ni, s, dev = accel.n_internal, accel.stack_depth, o.device
    tmin, tmax = ray_bounds(o, tmin, tmax)
    nt = -(-n // t)
    n_pad = nt * t

    def pad(x, fill):
        extra = torch.full((n_pad - n,) + x.shape[1:], fill, dtype=x.dtype,
                           device=dev)
        return torch.cat([x, extra])

    o_t = pad(o, 0.0).reshape(nt, t, 3)
    d_t = pad(d, 1.0).reshape(nt, t, 3)
    tmin_t = pad(tmin, 0.0).reshape(nt, t)
    tmax_t = pad(tmax, -1.0).reshape(nt, t)    # pad rays: empty interval
    rcp = 1.0 / d_t
    m_t = cross(o_t, d_t)
    r6 = [d_t[..., a, None] for a in range(3)] + [m_t[..., a, None]
                                                  for a in range(3)]
    o3 = [o_t[..., a, None] for a in range(3)]

    stack_i = torch.zeros((nt, s), dtype=torch.int64, device=dev)
    stack_t = torch.zeros((nt, s), dtype=torch.float32, device=dev)
    sp = (tmax_t >= tmin_t).any(-1).to(torch.int64)
    best = torch.full((nt, t), _BIG, device=dev)
    best_id = torch.zeros((nt, t), dtype=torch.int64, device=dev)
    nv = torch.zeros((), dtype=torch.int64, device=dev)
    tt = torch.zeros((), dtype=torch.int64, device=dev)
    while True:
        act = torch.nonzero(sp > 0)[:, 0]
        if act.numel() == 0:
            break
        sp[act] -= 1
        node = stack_i[act, sp[act]]
        ten = stack_t[act, sp[act]]
        cur = torch.minimum(tmax_t[act], best[act])         # (A, T)
        proc = ten <= cur.amax(-1)
        inner = proc & (node < ni)
        outer = proc & (node >= ni)
        if collect_stats:
            nv += inner.sum()
            tt += outer.sum() * k * t

        ia = act[inner]
        if ia.numel():
            nodes = node[inner]
            cb = accel.cbox[nodes][:, None, :]              # (M, 1, 12)
            oo, rr, lo, hi = o_t[ia], rcp[ia], tmin_t[ia], cur[inner]

            def child(c):
                ent, h = _slab_enter(oo, rr, cb[..., c:c + 3],
                                     cb[..., c + 3:c + 6], lo, hi)
                return (torch.where(h, ent, torch.inf).amin(-1),
                        h.any(-1))

            t_l, h_l = child(0)
            t_r, h_r = child(6)
            l_near = t_l <= t_r
            near_i = torch.where(l_near, 2 * nodes + 1, 2 * nodes + 2)
            far_i = torch.where(l_near, 2 * nodes + 2, 2 * nodes + 1)
            near_t = torch.where(l_near, t_l, t_r)
            far_t = torch.where(l_near, t_r, t_l)
            near_h = torch.where(l_near, h_l, h_r)
            far_h = torch.where(l_near, h_r, h_l)
            base = sp[ia]
            if bool(((base + far_h.long() + near_h.long()) > s).any()):
                raise RuntimeError("packet walk: stack overflow")
            for idx, tv, h, at in ((far_i, far_t, far_h, base),
                                   (near_i, near_t, near_h,
                                    base + far_h.long())):
                stack_i[ia[h], at[h]] = idx[h]
                stack_t[ia[h], at[h]] = tv[h]
            sp[ia] = base + far_h.long() + near_h.long()

        la = act[outer]
        if la.numel():
            leaf = (node[outer] - ni).clamp(0, accel.n_leaves - 1)
            w6 = accel.leaf_w6[leaf][:, None]               # (M, 1, 6, 3K)
            w4 = accel.leaf_w4[leaf][:, None]               # (M, 1, 4, K)
            rows = lambda c: [w6[:, :, r, c::3] for r in range(6)]
            tm = triangle_t(rows(0), rows(1), rows(2),
                            [w4[:, :, r] for r in range(4)],
                            [x[la] for x in r6], [x[la] for x in o3],
                            tmin_t[la][..., None], cur[outer][..., None])
            lt, lj = tm.min(-1)                             # (M, T)
            better = lt < best[la]
            best[la] = torch.where(better, lt, best[la])
            best_id[la] = torch.where(better, leaf[:, None] * k + lj,
                                      best_id[la])
            if any_hit:
                # a tile stops once every live ray is occluded
                done = ((best[la] < _BIG) | (tmax_t[la] < tmin_t[la])).all(-1)
                sp[la[done]] = 0
    out = (best.reshape(n_pad)[:n], best_id.reshape(n_pad)[:n].to(torch.int32))
    if collect_stats:
        return out + (TraversalStats(node_visits=nv, tri_tests=tt),)
    return out


def packet_closest_hit(accel: PacketAccel, tris, spheres, planes, o, d,
                       tmin=0.0, tmax=MIRO_TMAX, blpatches=None) -> Hit:
    """Scene::trace through the packet accelerator's tile walk, then
    spheres, planes and the bilinear patches (JAX ops/packet.py:276
    packet_closest_hit). `tris` is the pack `accel` was built from."""
    t, ids = packet_closest_hit_triangles(accel, o, d, tmin, tmax)
    return _then_pools(_hit(t, ids, PRIM_TRI), spheres, planes, o, d, tmin,
                       tmax, blpatches)


def packet_any_hit(accel: PacketAccel, tris, spheres, planes, o, d,
                   tmin=0.0, tmax=MIRO_TMAX, blpatches=None) -> torch.Tensor:
    """(N,) bool shadow occlusion through the packet walk and every other
    pool, with no gradient (JAX ops/packet.py:291 packet_any_hit)."""
    with torch.no_grad():
        t = packet_closest_hit_triangles(accel, o, d, tmin, tmax,
                                         any_hit=True)[0]
        return _occluded_by_pools(t < _BIG, spheres, planes, o, d, tmin,
                                  tmax, blpatches)
