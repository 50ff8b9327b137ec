"""sponza_proxy_lit: the port's registered sponza_proxy (scenes.build)
with its one point light moved below the ceiling, as the configuration
file states, and the same scene as raw data for the reference (its own
frozen copy of the procedural atrium)."""


def build_port(conf, device):
    """(Scene, SceneStatic, Camera, RenderConfig) of the port, without
    an accelerator."""
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.models.lights import (LIGHT_POINT,
                                                          make_light_table)
    from cse168_raytracer_tpu_torch.scenes import build
    cfg = RenderConfig(width=conf["width"], height=conf["height"],
                       trace_depth=conf["trace_depth"])
    scene, static, cam, cfg = build(conf["scene"], cfg, device=device)
    lights = [dict(kind=LIGHT_POINT, position=tuple(l["position"]),
                   color=tuple(l["color"]), wattage=l["wattage"])
              for l in conf["lights"]]
    scene = scene.replace(lights=make_light_table(lights, device))
    return scene, static, cam, cfg


def build_raw(conf):
    """The raw scene (portbench/reference/scene.py) of the reference."""
    from portbench.reference.sponza_mesh import sponza_proxy_mesh
    return dict(meshes=[(sponza_proxy_mesh(), 0)],
                materials=conf["materials"], lights=conf["lights"],
                camera=conf["camera"])
