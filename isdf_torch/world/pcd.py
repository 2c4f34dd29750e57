"""Minimal PCD point-cloud reader (ASCII + binary xyz) — replaces
pcl::PCDReader for the demo maps (ref globalmap_gene.cpp:433-446 pubPCDMap).

A copy of ``isdf_tpu/world/pcd.py`` (host numpy, no JAX): ``isdf_torch``
imports nothing of ``isdf_tpu``.
"""

from __future__ import annotations

import numpy as np


def load_pcd(path: str) -> np.ndarray:
    """Returns (N, 3) float64 points."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, rest = line.partition(" ")
            header[key] = rest.split()
            if key == "DATA":
                break
        fields = header.get("FIELDS", ["x", "y", "z"])
        sizes = [int(s) for s in header.get("SIZE", ["4"] * len(fields))]
        types = header.get("TYPE", ["F"] * len(fields))
        n = int(header.get("POINTS", header.get("WIDTH", ["0"]))[0])
        mode = header["DATA"][0]

        xyz_idx = [fields.index(a) for a in ("x", "y", "z")]
        if mode == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n)
            if data.ndim == 1:
                data = data[None]
            return data[:, xyz_idx]
        if mode == "binary":
            np_types = {
                ("F", 4): np.float32, ("F", 8): np.float64,
                ("I", 1): np.int8, ("I", 2): np.int16, ("I", 4): np.int32,
                ("U", 1): np.uint8, ("U", 2): np.uint16, ("U", 4): np.uint32,
            }
            dt = np.dtype(
                [
                    (name, np_types[(t, s)])
                    for name, t, s in zip(fields, types, sizes)
                ]
            )
            raw = np.frombuffer(f.read(n * dt.itemsize), dtype=dt, count=n)
            return np.stack(
                [raw["x"], raw["y"], raw["z"]], axis=-1
            ).astype(np.float64)
        raise ValueError(f"unsupported PCD DATA mode {mode!r}")
