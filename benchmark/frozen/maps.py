"""The obstacle clouds of the configurations' maps: copies of
``isdf_torch/world/maps_gen.py``'s ``map3`` (three narrow slit walls, demo
6's map) and ``map4`` (random floating blocks, standing in for demo 1's
absent CappedCone.pcd), numpy only."""

from __future__ import annotations

import numpy as np


def _jitter(rng, n):
    j = np.empty((n, 3))
    j[:, 0] = rng.integers(0, 10, n) / 250.0
    j[:, 1] = rng.integers(0, 10, n) / 250.0
    j[:, 2] = rng.integers(0, 10, n) / 800.0
    return j


def gene_wall(ox, oy, length, width, height, oz=0.0, res=0.1, rng=None):
    xs = np.arange(ox, ox + length, res)
    ys = np.arange(oy, oy + width, res)
    zs = np.arange(oz, oz + height, res)
    g = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), axis=-1)
    g = g.reshape(-1, 3)
    if rng is not None:
        g = g + _jitter(rng, len(g))
    return g


def map3(res=0.1, seed=0):
    rng = np.random.default_rng(seed)
    walls = [
        (0, 0, 0.2, 0.2, 3.0, 0.0), (50, 50, 0.2, 0.2, 3.0, 15.0),
        (10.0, 0.0, 2.0, 2.0, 14.0, 0.0), (10.0, 10.0, 2.0, 2.0, 14.0, 0.0),
        (10.0, 2.0, 2.0, 8.0, 3.0, 0.0), (10.0, 2.0, 2.0, 8.0, 2.0, 12.0),
        (10.0, 5.0, 2.0, 5.0, 5.5, 3.0), (10.0, 10.0, 2.0, 40.0, 15.0, 0.0),
        (20.0, 0.0, 2.0, 2.0, 14.0, 0.0), (20.0, 10.0, 2.0, 2.0, 14.0, 0.0),
        (20.0, 2.0, 2.0, 8.0, 5.0, 0.0), (20.0, 2.0, 2.0, 8.0, 0.0, 14.0),
        (20.0, 5.0, 2.0, 5.0, 5.5, 5.0), (20.0, 10.0, 2.0, 40.0, 15.0, 0.0),
        (10.0, 0.0, 2.0, 50.0, 5.0, 13.0), (20.0, 0.0, 2.0, 50.0, 5.0, 13.0),
    ]
    return np.concatenate([gene_wall(x, y, l, w, h, oz=z, res=res, rng=rng)
                           for x, y, l, w, h, z in walls], axis=0)


def map4(res=0.1, seed=0, num=250):
    rng = np.random.default_rng(seed)
    parts = [
        gene_wall(0, 0, 0.2, 0.2, 3.0, res=res, rng=rng),
        gene_wall(60, 60, 0.2, 0.2, 3.0, oz=35.0, res=res, rng=rng),
    ]
    side = 1.5 * res
    for _ in range(num):
        x = (rng.integers(0, 450) + 50) / 10
        y = (rng.integers(0, 450) + 50) / 10
        z = (rng.integers(0, 250) + 50) / 10
        parts.append(gene_wall(x, y, side, side, side, oz=z, res=res, rng=rng))
    return np.concatenate(parts, axis=0)


MAPS = {"map3": map3, "map4": map4}
