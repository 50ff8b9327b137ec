"""photon_box_maps: photon_box's scene (the meshes of photon_box.py,
imported from there) with the configuration's photon-map sizes carried
into the port's RenderConfig."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "portbench_config_photon_box_scene",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "photon_box.py"))
box = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(box)

# the configuration's "photons" keys, each a RenderConfig field
PHOTON_KEYS = ("photons_per_light", "caustic_photons_per_light",
               "photon_samples", "trace_depth_photons",
               "photon_grid_max_per_cell", "photon_coarse_factor",
               "photon_max_batches")


def build_port(conf, device):
    """(Scene, SceneStatic, Camera, RenderConfig) of the port, without
    an accelerator or photon maps; the RenderConfig carries the map
    sizes."""
    scene, static, cam, cfg = box.build_port(conf, device)
    return scene, static, cam, cfg.replace(
        **{k: conf["photons"][k] for k in PHOTON_KEYS})


def build_raw(conf):
    """The raw scene (portbench/reference/scene.py) of the reference."""
    return box.build_raw(conf)
