"""The stand-in mesh body of the L configuration (an L-shaped hexagon
extruded, as ``isdf_torch/shapes/mesh.py``'s ``l_prism``) and the OBJ file
the program reads it from."""

from __future__ import annotations

import numpy as np


def l_ring(arm_x: float, arm_y: float, thick: float) -> np.ndarray:
    """The L's outline (6, 2), counter-clockwise, centred on its box."""
    t = thick
    ring = np.array([[0.0, 0.0], [arm_x, 0.0], [arm_x, t], [t, t],
                     [t, arm_y], [0.0, arm_y]])
    return ring - np.array([arm_x, arm_y]) / 2


def l_prism(arm_x: float, arm_y: float, thick: float):
    """-> (V (12, 3), F (20, 3)), faces outward, centred on its box."""
    ring = l_ring(arm_x, arm_y, thick) + np.array([arm_x, arm_y]) / 2
    V = np.concatenate([np.c_[ring, np.zeros(6)],
                        np.c_[ring, np.full(6, thick)]])
    V -= np.array([arm_x, arm_y, thick]) / 2
    cap = [(3, 0, 1), (3, 1, 2), (3, 4, 5), (3, 5, 0)]
    F = [(a + 6, b + 6, c + 6) for a, b, c in cap]
    F += [(a, c, b) for a, b, c in cap]
    for i in range(6):
        j = (i + 1) % 6
        F += [(i, j, j + 6), (i, j + 6, i + 6)]
    return V, np.asarray(F, dtype=np.int32)


def write_obj(path: str, V: np.ndarray, F: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in np.asarray(V, dtype=np.float64):
            f.write("v " + " ".join(repr(float(c)) for c in v) + "\n")
        for tri in np.asarray(F):
            f.write("f " + " ".join(str(int(i) + 1) for i in tri) + "\n")
