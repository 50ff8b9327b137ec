"""A frozen copy of the procedural atrium that stands in for sponza.obj.

The port's registry builds `sponza_proxy` from the same procedure
(scenes/registry.py, `_make_sponza_proxy`, as of the benchmark's first
version). The reference keeps its own copy, so that the geometry it
renders is the benchmark's and not whatever the port builds: a change
to the port's procedure that moves a vertex shows as a wrong image.
"""

import numpy as np


def sponza_proxy_mesh(target_tris: int = 160_000):
    """A sponza-SHAPED benchmark interior: two-story colonnaded atrium
    with round fluted columns, arch rings, a coffered ceiling and
    floor clutter, ~160k triangles, rendered from INSIDE — built so
    the traversal workload profile approaches the real sponza's
    interior-occlusion numbers (the reference measured 10.33
    triangle tests/ray there vs 1.17 for bunny,
    writeup/A2/Readme.tex:95-98). NOT the Crytek geometry: sponza.obj
    is stripped from the snapshot; this is the documented stand-in
    for the rays/sec-at-sponza headline metric (BASELINE.md)."""
    verts = []
    tris = []

    def quad(a, b, c, d):
        base = len(verts)
        verts.extend([a, b, c, d])
        tris.append((base, base + 1, base + 2))
        tris.append((base, base + 2, base + 3))

    def grid_wall(p0, du, dv, nu, nv):
        """Subdivided planar wall: p0 + u*du + v*dv, (nu x nv) quads."""
        p0 = np.asarray(p0, np.float64)
        du = np.asarray(du, np.float64) / nu
        dv = np.asarray(dv, np.float64) / nv
        for i in range(nu):
            for j in range(nv):
                a = p0 + i * du + j * dv
                quad(tuple(a), tuple(a + du), tuple(a + du + dv),
                     tuple(a + dv))

    def cylinder(cx, cz, y0, y1, r, seg=24, rings=6, flute=0.0):
        """Fluted column shaft: seg x rings quads."""
        ys = np.linspace(y0, y1, rings + 1)
        for k in range(rings):
            for i in range(seg):
                a0 = 2 * np.pi * i / seg
                a1 = 2 * np.pi * (i + 1) / seg
                r0 = r * (1 + flute * np.cos(8 * a0))
                r1 = r * (1 + flute * np.cos(8 * a1))
                quad((cx + r0 * np.cos(a0), ys[k], cz + r0 * np.sin(a0)),
                     (cx + r1 * np.cos(a1), ys[k], cz + r1 * np.sin(a1)),
                     (cx + r1 * np.cos(a1), ys[k + 1],
                      cz + r1 * np.sin(a1)),
                     (cx + r0 * np.cos(a0), ys[k + 1],
                      cz + r0 * np.sin(a0)))

    def arch(cx, cz, y, r, width, seg=16):
        """Half-torus arch ring between two columns (axis along x)."""
        for i in range(seg):
            a0 = np.pi * i / seg
            a1 = np.pi * (i + 1) / seg
            for zs in (-width / 2, width / 2):
                quad((cx + r * np.cos(a0), y + r * np.sin(a0), cz + zs),
                     (cx + r * np.cos(a1), y + r * np.sin(a1), cz + zs),
                     (cx + (r - 0.15) * np.cos(a1),
                      y + (r - 0.15) * np.sin(a1), cz + zs),
                     (cx + (r - 0.15) * np.cos(a0),
                      y + (r - 0.15) * np.sin(a0), cz + zs))

    def box(cx, cy, cz, sx, sy, sz):
        base = len(verts)
        for dx in (-sx, sx):
            for dy in (-sy, sy):
                for dz in (-sz, sz):
                    verts.append((cx + dx, cy + dy, cz + dz))
        for f in [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5),
                  (0, 4, 5), (0, 5, 1), (2, 3, 7), (2, 7, 6),
                  (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)]:
            tris.append((base + f[0], base + f[1], base + f[2]))

    rng = np.random.RandomState(0)
    L, W, H = 14.0, 7.0, 9.0          # atrium half-length/width, height
    # floor / ceiling / end walls, subdivided so the BVH sees real leaf
    # structure everywhere rays travel
    grid_wall((-L, 0, -W), (2 * L, 0, 0), (0, 0, 2 * W), 56, 28)
    grid_wall((-L, H, -W), (2 * L, 0, 0), (0, 0, 2 * W), 56, 28)
    grid_wall((-L, 0, -W), (0, H, 0), (2 * L, 0, 0), 24, 56)   # back z=-W
    grid_wall((-L, 0, W), (0, H, 0), (2 * L, 0, 0), 24, 56)    # front
    grid_wall((-L, 0, -W), (0, H, 0), (0, 0, 2 * W), 24, 28)
    grid_wall((L, 0, -W), (0, H, 0), (0, 0, 2 * W), 24, 28)
    # two stories of fluted columns with arch rings along both sides
    n_cols = 12
    xs_c = np.linspace(-L + 1.4, L - 1.4, n_cols)
    for zi, zc in enumerate((-W + 1.6, W - 1.6)):
        for story, (y0, y1) in enumerate(((0.0, 3.4), (4.2, 7.2))):
            for x in xs_c:
                cylinder(x, zc, y0, y1, 0.38, seg=28, rings=8,
                         flute=0.06)
                box(x, y1 + 0.15, zc, 0.55, 0.15, 0.55)   # capital
                box(x, y0 + 0.08 if story else 0.08, zc,
                    0.5, 0.08, 0.5)                        # plinth
            # arches spanning neighboring columns
            span = xs_c[1] - xs_c[0]
            for x in (xs_c[:-1] + span / 2):
                arch(x, zc, (3.4, 7.2)[story], span / 2 - 0.1, 0.5,
                     seg=14)
        # second-story walkway slab
        box(0, 3.9, zc, L, 0.12, 1.3)
    # coffered ceiling beams
    for x in xs_c:
        box(x, H - 0.25, 0, 0.18, 0.25, W)
    for z in np.linspace(-W + 1, W - 1, 9):
        box(0, H - 0.45, z, L, 0.12, 0.18)
    # floor clutter: crates and debris at many scales
    while len(tris) < target_tris - 40:
        x = rng.uniform(-L + 1, L - 1)
        z = rng.uniform(-W + 1, W - 1)
        sc = rng.uniform(0.08, 0.45)
        box(x, sc, z, sc * rng.uniform(0.5, 1.5), sc,
            sc * rng.uniform(0.5, 1.5))

    v = np.asarray(verts, np.float32)
    f = np.asarray(tris, np.int32)
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    normals = np.repeat(n, 3, axis=0)
    nidx = np.arange(f.shape[0] * 3, dtype=np.int32).reshape(-1, 3)
    return {"vertices": v, "normals": normals.astype(np.float32),
            "texcoords": np.zeros((0, 2), np.float32),
            "tri_vidx": f, "tri_nidx": nidx,
            "tri_tidx": np.full_like(f, -1)}
