"""photon_box: the procedural stand-in for photon_cornell, made here
from the configuration file's sizes and handed as the same raw meshes to
the port's constructors and to the reference.

An open-front box of triangles (floor, ceiling and back wall white, the
left wall red, the right green), a tessellated glass sphere under a
directional-area light, and photon_cornell's camera."""

import numpy as np


def quad(a, b, c, d, normal):
    """Two triangles (a, b, c) and (a, c, d) of a planar quad with one
    shading normal."""
    v = np.asarray([a, b, c, d], np.float32)
    f = np.asarray([[0, 1, 2], [0, 2, 3]], np.int64)
    return {"vertices": v, "normals": np.tile(np.float32(normal), (4, 1)),
            "texcoords": np.zeros((0, 2), np.float32), "tri_vidx": f,
            "tri_nidx": f, "tri_tidx": np.full((2, 3), -1, np.int64)}


def uv_sphere(center, radius, rings):
    """A sphere with smooth (vertex) normals: `rings` bands of 2 * rings
    segments, 4 * rings * (rings - 1) triangles (one a segment in the two
    polar bands, two elsewhere)."""
    seg = 2 * rings
    th = np.linspace(0, np.pi, rings + 1)
    ph = np.linspace(0, 2 * np.pi, seg + 1)[:-1]
    n = np.stack([np.sin(th)[:, None] * np.cos(ph)[None],
                  np.cos(th)[:, None] * np.ones_like(ph)[None],
                  np.sin(th)[:, None] * np.sin(ph)[None]], -1).reshape(-1, 3)
    idx = np.arange((rings + 1) * seg).reshape(rings + 1, seg)
    nxt = np.roll(idx, -1, axis=1)
    tris = []
    for i in range(rings):
        a, b, c, d = idx[i], nxt[i], nxt[i + 1], idx[i + 1]
        if i > 0:
            tris.append(np.stack([a, b, c], 1))
        if i < rings - 1:
            tris.append(np.stack([a, c, d], 1))
    f = np.concatenate(tris).astype(np.int64)
    v = (np.float64(center) + radius * n).astype(np.float32)
    return {"vertices": v, "normals": n.astype(np.float32),
            "texcoords": np.zeros((0, 2), np.float32), "tri_vidx": f,
            "tri_nidx": f, "tri_tidx": np.full_like(f, -1)}


def meshes(conf):
    """[(mesh, material index)]: the five walls, then the sphere."""
    x0, x1, y0, y1, z0, z1 = conf["box"]
    sph = conf["sphere"]
    return [
        (quad((x0, y0, z1), (x1, y0, z1), (x1, y0, z0), (x0, y0, z0),
              (0, 1, 0)), 0),                                  # floor
        (quad((x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1),
              (0, -1, 0)), 0),                                 # ceiling
        (quad((x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0),
              (0, 0, 1)), 0),                                  # back wall
        (quad((x0, y0, z0), (x0, y1, z0), (x0, y1, z1), (x0, y0, z1),
              (1, 0, 0)), 1),                                  # left
        (quad((x1, y0, z1), (x1, y1, z1), (x1, y1, z0), (x1, y0, z0),
              (-1, 0, 0)), 2),                                 # right
        (uv_sphere(sph["center"], sph["radius"], sph["rings"]), 3)]


def build_port(conf, device):
    """(Scene, SceneStatic, Camera, RenderConfig) of the port, without
    an accelerator."""
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.models.geometry import pack_triangles
    from cse168_raytracer_tpu_torch.models.lights import \
        LIGHT_DIRECTIONAL_AREA
    from cse168_raytracer_tpu_torch.models.materials import MaterialBuilder
    from cse168_raytracer_tpu_torch.models.scene import make_scene
    from cse168_raytracer_tpu_torch.render.camera import make_camera
    mb = MaterialBuilder()
    ids = [mb.phong(kd=tuple(m.get("kd", (1, 1, 1))),
                    ks=tuple(m.get("ks", (0, 0, 0))),
                    kt=tuple(m.get("kt", (0, 0, 0))),
                    shininess=m.get("shininess", 1.0), ior=m.get("ior", 1.0))
           for m in conf["materials"]]
    lights = [dict(kind=LIGHT_DIRECTIONAL_AREA, position=tuple(l["position"]),
                   normal=tuple(l["normal"]), radius=l["radius"],
                   color=tuple(l["color"]), wattage=l["wattage"])
              for l in conf["lights"]]
    scene, static = make_scene(
        tris=pack_triangles([(m, ids[k]) for m, k in meshes(conf)],
                            device=device),
        materials=mb.build(device), lights=lights, device=device)
    c = conf["camera"]
    cam = make_camera(eye=tuple(c["eye"]), look_at=tuple(c["look_at"]),
                      up=tuple(c["up"]), fov=c["fov"], device=device)
    cfg = RenderConfig(width=conf["width"], height=conf["height"],
                       trace_depth=conf["trace_depth"])
    return scene, static, cam, cfg


def build_raw(conf):
    """The raw scene (portbench/reference/scene.py) of the reference."""
    return dict(meshes=meshes(conf), materials=conf["materials"],
                lights=conf["lights"], camera=conf["camera"])
