"""The system under test, built from a configuration's file: its Config,
its body and its map.  The benchmark makes every input itself (the cloud,
the mesh) and hands it to the program through its public entry points."""

from __future__ import annotations

import os
import tempfile

import numpy as np

from benchmark.frozen import maps, shapes


def cloud(config: dict) -> np.ndarray:
    m = config["map"]
    return maps.MAPS[m["name"]](res=m["res"], seed=m["seed"])


def build(config: dict, device):
    """-> (isdf_torch Config, Shape) of the configuration on ``device``."""
    from isdf_torch.config import Config
    from isdf_torch.shapes import make_shape, shape_from_config

    body = config["body"]
    conf = Config(**config["settings"])
    if body["program"] == "zoo":
        return conf, make_shape(body["name"], conf)
    # a mesh body: the OBJ the config names, written where the run may
    # write, read back and baked by the program as a user's file would be
    V, F = shapes.l_prism(body["arm_x"], body["arm_y"], body["thick"])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, body["name"] + ".obj")
        shapes.write_obj(path, V, F)
        conf = conf.replace(inputdata=path)
        shape = shape_from_config(conf, device=device)
    return conf, shape
