"""Procedural obstacle-map generators (point clouds), seeded and reproducible.

Ports the behaviours of the reference's ``globalmap_gene`` node
(ref src/map_manager/src/globalmap_gene.cpp:26-418): walls, random forests,
narrow slits, random-block fields, sin planes, roads, spirals, and the named
map ids 1-11 used by the demos (map3 = three narrow slit walls, map4 = random
blocks, map5 = single slit, map9 = slit ramp, …).  ``srand``/noise jitter is
replaced by an explicit seeded Generator.

Copied unchanged from ``isdf_tpu/world/maps_gen.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np


def _jitter(rng, n):
    """Reference adds (rand()%10)/250 in x/y and /800 in z."""
    j = np.empty((n, 3))
    j[:, 0] = rng.integers(0, 10, n) / 250.0
    j[:, 1] = rng.integers(0, 10, n) / 250.0
    j[:, 2] = rng.integers(0, 10, n) / 800.0
    return j


def gene_wall(ox, oy, length, width, height, oz=0.0, res=0.1, rng=None):
    """Dense voxel-sampled box of points (ref globalmap_gene.cpp:26-63)."""
    xs = np.arange(ox, ox + length, res)
    ys = np.arange(oy, oy + width, res)
    zs = np.arange(oz, oz + height, res)
    g = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), axis=-1).reshape(-1, 3)
    if rng is not None:
        g = g + _jitter(rng, len(g))
    return g


def gene_sin_plane(ox, oy, cz, ex, ey, t, h, res=0.1, rng=None):
    xs = np.arange(ox, ex, res)
    ys = np.arange(oy, ey, res)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    Z = np.maximum(cz + h * np.sin(t * X) + h * np.sin(t * Y), cz)
    g = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    if rng is not None:
        g = g + _jitter(rng, len(g))
    return g


def gene_triangle(ox, oy, height, depth, length, oz=0.0, res=0.1, rng=None):
    """Triangular prism wedge: vertical face at x=ox tapering to a ridge
    (ref globalmap_gene.cpp:66-106 geneTrangle)."""
    zs = np.arange(oz, oz + height, res)
    parts = []
    for z in zs:
        frac = 1.0 - (z - oz) / max(height, 1e-9)
        d = depth * frac
        if d < res:
            d = res
        parts.append(gene_wall(ox, oy, d, length, res, oz=z, res=res, rng=rng))
    return np.concatenate(parts, axis=0)


def gene_road(start, end, width, res=0.1, rng=None):
    start, end = np.asarray(start, float), np.asarray(end, float)
    d = end - start
    L = np.linalg.norm(d)
    expand = np.array([-d[1], d[0], 0.0])
    nrm = np.linalg.norm(expand)
    expand = expand / (nrm if nrm > 0 else 1.0) * width
    ts = np.arange(0.0, 1.0 + 1e-9, res / max(L, 1e-9))
    ks = np.arange(-0.5, 0.5 + 1e-9, res / max(width, 1e-9))
    P = (
        start[None, None]
        + ts[:, None, None] * d[None, None]
        + ks[None, :, None] * expand[None, None]
    ).reshape(-1, 3)
    if rng is not None:
        P = P + _jitter(rng, len(P))
    return P


def gene_spiral(cx, cy, oz, ez, radius, width, t, res=0.1, rng=None):
    zs = np.arange(oz, ez, res / (6 * t))
    ws = np.arange(radius, radius + width, res)
    phi = t * (zs - oz)
    X = cx + ws[None, :] * np.sin(phi[:, None])
    Y = cy + ws[None, :] * np.cos(phi[:, None])
    Z = np.broadcast_to(zs[:, None], X.shape)
    g = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    if rng is not None:
        g = g + _jitter(rng, len(g))
    return g


# --- named demo maps (ids follow globalmap_gene.cpp:405-418) ----------------
def map1(res=0.1, seed=0):
    """Two stacked gate walls (ref globalmap_gene.cpp:174-182)."""
    rng = np.random.default_rng(seed)
    parts = [
        gene_wall(0, 0, 0.2, 0.2, 3.0, res=res, rng=rng),
        gene_wall(50, 20, 0.2, 0.2, 3.0, oz=15.0, res=res, rng=rng),
        gene_wall(25.0, 0.0, 2.0, 10.0, 5.0, res=res, rng=rng),
        gene_wall(25.0, 0.0, 2.0, 10.0, 5.0, oz=7.0, res=res, rng=rng),
    ]
    return np.concatenate(parts, axis=0)


def map6(res=0.1, seed=0):
    """Empty arena with corner anchor posts (ref globalmap_gene.cpp:325-330)."""
    rng = np.random.default_rng(seed)
    parts = [
        gene_wall(0, 0, 0.2, 0.2, 3.0, res=res, rng=rng),
        gene_wall(60, 60, 0.2, 0.2, 3.0, oz=35.0, res=res, rng=rng),
    ]
    return np.concatenate(parts, axis=0)


def map7(res=0.1, seed=0):
    """Multi-opening wall maze at x=30 (ref globalmap_gene.cpp:332-350)."""
    rng = np.random.default_rng(seed)
    parts = [
        gene_wall(0, 0, 0.2, 0.2, 3.0, res=res, rng=rng),
        gene_wall(60, 60, 0.2, 0.2, 3.0, oz=35.0, res=res, rng=rng),
        gene_wall(30, 0, 1.1, 60.0, 8.0, res=res, rng=rng),
        gene_wall(30, 0, 1.1, 25.0, 7.0, oz=5.0, res=res, rng=rng),
        gene_wall(30, 35.0, 1.1, 25.0, 7.0, oz=5.0, res=res, rng=rng),
        gene_wall(30, 0.0, 1.1, 21.0, 9.0, oz=12.0, res=res, rng=rng),
        gene_wall(30, 39.0, 1.1, 21.0, 9.0, oz=12.0, res=res, rng=rng),
        gene_wall(30, 0.0, 1.1, 60.0, 4.0, oz=21.0, res=res, rng=rng),
        gene_wall(30, 28.0, 1.1, 4.0, 2.0, oz=14.0, res=res, rng=rng),
    ]
    return np.concatenate(parts, axis=0)


def map8(res=0.1, seed=0):
    """Arena with a single isolated obstacle point at its center
    (ref globalmap_gene.cpp:352-364)."""
    rng = np.random.default_rng(seed)
    parts = [
        gene_wall(0, 0, 0.2, 0.2, 3.0, res=res, rng=rng),
        gene_wall(60, 60, 0.2, 0.2, 3.0, oz=35.0, res=res, rng=rng),
        np.array([[30.0, 30.0, 2.0]]),
    ]
    return np.concatenate(parts, axis=0)


def map10(res=0.1, seed=0):
    """Three tall parallel walls + a high cross-bar + floor slab
    (ref globalmap_gene.cpp:229-248)."""
    rng = np.random.default_rng(seed)
    parts = [
        gene_wall(0, 0, 0.2, 0.2, 3.0, res=res, rng=rng),
        gene_wall(50, 50, 0.2, 0.2, 3.0, oz=15.0, res=res, rng=rng),
        gene_wall(10.0, 0.0, 2.0, 50.0, 35.0, res=res, rng=rng),
        gene_wall(25.0, 0.0, 2.0, 50.0, 35.0, res=res, rng=rng),
        gene_wall(40.0, 0.0, 2.0, 50.0, 35.0, res=res, rng=rng),
        gene_wall(10.0, 49.0, 30.0, 1.0, 35.0, res=res, rng=rng),
        gene_wall(0.0, 0.0, 50.0, 50.0, 1.0, oz=-1.0, res=res, rng=rng),
    ]
    return np.concatenate(parts, axis=0)


def map11(res=0.1, seed=0, num=300):
    """Dense random small-block field (ref globalmap_gene.cpp:282-311)."""
    rng = np.random.default_rng(seed)
    parts = [
        gene_wall(0, 0, 0.2, 0.2, 3.0, res=res, rng=rng),
        gene_wall(60, 60, 0.2, 0.2, 3.0, oz=35.0, res=res, rng=rng),
    ]
    side = 1.5 * res
    for _ in range(num):
        x = (rng.integers(0, 450) + 15) / 10
        y = (rng.integers(0, 450) + 15) / 10
        z = (rng.integers(0, 250) + 50) / 10
        parts.append(gene_wall(x, y, side, side, side, oz=z, res=res, rng=rng))
    return np.concatenate(parts, axis=0)


def map3(res=0.1, seed=0):
    """Three consecutive narrow-slit walls (demo6's map)."""
    rng = np.random.default_rng(seed)
    parts = [
        gene_wall(0, 0, 0.2, 0.2, 3.0, res=res, rng=rng),
        gene_wall(50, 50, 0.2, 0.2, 3.0, oz=15.0, res=res, rng=rng),
        gene_wall(10.0, 0.0, 2.0, 2.0, 14.0, res=res, rng=rng),
        gene_wall(10.0, 10.0, 2.0, 2.0, 14.0, res=res, rng=rng),
        gene_wall(10.0, 2.0, 2.0, 8.0, 3.0, res=res, rng=rng),
        gene_wall(10.0, 2.0, 2.0, 8.0, 2.0, oz=12.0, res=res, rng=rng),
        gene_wall(10.0, 5.0, 2.0, 5.0, 5.5, oz=3.0, res=res, rng=rng),
        gene_wall(10.0, 10.0, 2.0, 40.0, 15.0, res=res, rng=rng),
        gene_wall(20.0, 0.0, 2.0, 2.0, 14.0, res=res, rng=rng),
        gene_wall(20.0, 10.0, 2.0, 2.0, 14.0, res=res, rng=rng),
        gene_wall(20.0, 2.0, 2.0, 8.0, 5.0, res=res, rng=rng),
        gene_wall(20.0, 2.0, 2.0, 8.0, 0.0, oz=14.0, res=res, rng=rng),
        gene_wall(20.0, 5.0, 2.0, 5.0, 5.5, oz=5.0, res=res, rng=rng),
        gene_wall(20.0, 10.0, 2.0, 40.0, 15.0, res=res, rng=rng),
        gene_wall(10.0, 0.0, 2.0, 50.0, 5.0, oz=13.0, res=res, rng=rng),
        gene_wall(20.0, 0.0, 2.0, 50.0, 5.0, oz=13.0, res=res, rng=rng),
    ]
    return np.concatenate(parts, axis=0)


def map4(res=0.1, seed=0, num=250):
    """Random floating blocks (demo1's map)."""
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


def map5(res=0.1, seed=0):
    """Single narrow horizontal slit (demo5's map)."""
    rng = np.random.default_rng(seed)
    parts = [
        gene_wall(0, 0, 0.2, 0.2, 3.0, res=res, rng=rng),
        gene_wall(60, 60, 0.2, 0.2, 3.0, oz=35.0, res=res, rng=rng),
        gene_wall(30, 0, 2.0, 50, 15.0, res=res, rng=rng),
        gene_wall(30, 0, 2.0, 50, 16.0, oz=18.0, res=res, rng=rng),
    ]
    return np.concatenate(parts, axis=0)


def map9(res=0.1, seed=0):
    """Slit ramp of stacked inclined roads (demo5 variant)."""
    rng = np.random.default_rng(seed)
    parts = [
        gene_wall(0, 0, 0.2, 0.2, 3.0, res=res, rng=rng),
        gene_wall(60, 60, 0.2, 0.2, 3.0, oz=35.0, res=res, rng=rng),
    ]
    for h in np.arange(-60.0, 30.0, 0.5):
        if 0.0 < h < 5.5:
            continue
        spt = np.array([0.0, 20.0, h])
        if h < 0:
            spt = np.array([-h, 20.0, 0.0])
        ept = spt + np.array([50.0 - spt[0], 0.0, 45.0])
        parts.append(gene_road(spt, ept, 0.5, res=res, rng=rng))
    return np.concatenate(parts, axis=0)


def map_random_forest(res=0.1, seed=0, trees=20, area=60.0, start=(0.0, 0.0)):
    """Random pillar forest (map2)."""
    rng = np.random.default_rng(seed)
    parts = [
        gene_wall(0, 0, 0.2, 0.2, 3.0, res=res, rng=rng),
        gene_wall(100, 100, 0.2, 0.2, 3.0, res=res, rng=rng),
    ]
    n = 0
    while n < trees:
        x = rng.integers(0, 3000) / 50.0
        y = rng.integers(0, 3000) / 50.0
        if np.hypot(x - start[0], y - start[1]) < 0.3:
            continue
        parts.append(gene_wall(x, y, 5, 5, 20, res=res, rng=rng))
        n += 1
    return np.concatenate(parts, axis=0)


MAP_GENERATORS = {
    1: map1,
    2: map_random_forest,
    3: map3,
    4: map4,
    5: map5,
    6: map6,
    7: map7,
    8: map8,
    9: map9,
    10: map10,
    11: map11,
}


def generate(map_id: int, res: float = 0.1, seed: int = 0) -> np.ndarray:
    if map_id not in MAP_GENERATORS:
        raise KeyError(f"map id {map_id} not implemented; have {sorted(MAP_GENERATORS)}")
    return MAP_GENERATORS[map_id](res=res, seed=seed)


# --- mockamap-style random noise maps (ref src/uav_simulator/mockamap) ------
def _perlin3(shape, feature, rng):
    """Simple 3-D gradient (Perlin) noise on a grid, values ≈ [−1, 1]."""
    gx = np.array(shape) // feature + 2
    grads = rng.normal(size=(*gx, 3))
    grads /= np.linalg.norm(grads, axis=-1, keepdims=True) + 1e-12

    coords = np.stack(
        np.meshgrid(*[np.arange(s) / feature for s in shape], indexing="ij"),
        axis=-1,
    )
    i0 = coords.astype(int)
    f = coords - i0

    def fade(t):
        return t * t * t * (t * (t * 6 - 15) + 10)

    w = fade(f)
    total = np.zeros(shape)
    for cx in range(2):
        for cy in range(2):
            for cz in range(2):
                corner = i0 + np.array([cx, cy, cz])
                g = grads[corner[..., 0], corner[..., 1], corner[..., 2]]
                d = f - np.array([cx, cy, cz])
                dot = np.sum(g * d, axis=-1)
                wx = w[..., 0] if cx else 1 - w[..., 0]
                wy = w[..., 1] if cy else 1 - w[..., 1]
                wz = w[..., 2] if cz else 1 - w[..., 2]
                total += dot * wx * wy * wz
    return total


def mockamap(size=(40, 40, 15), res=0.5, seed=0, feature=6, fill=0.12):
    """Perlin-noise obstacle field (the mockamap alternative map source,
    ref src/uav_simulator/mockamap/src/maps.cpp perlin3D type): threshold
    the noise at the `fill` occupancy quantile, return occupied voxel
    centers as a point cloud."""
    rng = np.random.default_rng(seed)
    noise = _perlin3(tuple(size), feature, rng)
    thresh = np.quantile(noise, 1.0 - fill)
    idx = np.argwhere(noise >= thresh)
    return (idx + 0.5) * res


def _recursive_division(maze, xl, xh, yl, yh, rng):
    """Recursive-division maze carving on an occupancy grid (the mockamap
    maze2D generator, ref src/uav_simulator/mockamap/src/maps.cpp:180-498):
    split the chamber with a cross wall through a random interior center,
    open 3 of the 4 wall arms at random doors, re-open doors where the new
    wall blocked an existing opening on the chamber boundary, recurse into
    the four sub-chambers.  Degenerate chamber sizes (4-wide, 3-wide) get
    the reference's single-wall / single-block treatments."""
    if xl < xh - 3 and yl < yh - 3:
        xm = int(rng.integers(xl + 1, xh))
        ym = int(rng.integers(yl + 1, yh))
        maze[xl:xh + 1, ym] = 1
        maze[xm, yl:yh + 1] = 1
        d1 = int(rng.integers(xl, xm))
        d2 = int(rng.integers(xm + 1, xh + 1))
        d3 = int(rng.integers(yl, ym))
        d4 = int(rng.integers(ym + 1, yh + 1))
        doors = [[(d1, ym), (d2, ym), (xm, d3)],
                 [(d1, ym), (d2, ym), (xm, d4)],
                 [(d2, ym), (xm, d3), (xm, d4)],
                 [(d1, ym), (xm, d3), (xm, d4)]][int(rng.integers(4))]
        for (di, dj) in doors:
            maze[di, dj] = 0
        # keep openings on the chamber boundary connected through the new
        # cross wall (maps.cpp:275-307)
        if yl - 1 >= 0 and maze[xm, yl - 1] == 0:
            maze[xm, yl] = 0
        if yh + 1 <= maze.shape[1] - 1 and maze[xm, yh + 1] == 0:
            maze[xm, yh] = 0
        if xl - 1 >= 0 and maze[xl - 1, ym] == 0:
            maze[xl, ym] = 0
        if xh + 1 <= maze.shape[0] - 1 and maze[xh + 1, ym] == 0:
            maze[xh, ym] = 0
        _recursive_division(maze, xl, xm - 1, yl, ym - 1, rng)
        _recursive_division(maze, xm + 1, xh, yl, ym - 1, rng)
        _recursive_division(maze, xl, xm - 1, ym + 1, yh, rng)
        _recursive_division(maze, xm + 1, xh, ym + 1, yh, rng)
    elif xl < xh - 2 and yl < yh - 2:
        xm = int(rng.integers(xl + 1, xh))
        ym = int(rng.integers(yl + 1, yh))
        maze[xl:xh + 1, ym] = 1
        maze[xm, yl:yh + 1] = 1
        if yl - 1 >= 0 and maze[xm, yl - 1] == 0:
            maze[xm, yl] = 0
        if yh + 1 <= maze.shape[1] - 1 and maze[xm, yh + 1] == 0:
            maze[xm, yh] = 0
        if xl - 1 >= 0 and maze[xl - 1, ym] == 0:
            maze[xl, ym] = 0
        if xh + 1 <= maze.shape[0] - 1 and maze[xh + 1, ym] == 0:
            maze[xh, ym] = 0
        d1 = int(rng.integers(xl, xm))
        d2 = int(rng.integers(xm + 1, xh + 1))
        d3 = int(rng.integers(yl, ym))
        d4 = int(rng.integers(ym + 1, yh + 1))
        doors = [[(d1, ym), (d2, ym), (xm, d3)],
                 [(d1, ym), (d2, ym), (xm, d4)],
                 [(d2, ym), (xm, d3), (xm, d4)],
                 [(d1, ym), (xm, d3), (xm, d4)]][int(rng.integers(4))]
        for (di, dj) in doors:
            maze[di, dj] = 0
    elif xl < xh - 1 and yl < yh - 2:      # 3-wide chamber: single y wall
        maze[xl + 1, yl:yh + 1] = 1
        doors = 0
        if yl - 1 >= 0 and maze[xl + 1, yl - 1] == 0:
            maze[xl + 1, yl] = 0
            doors += 1
        if yh + 1 <= maze.shape[1] - 1 and maze[xl + 1, yh + 1] == 0:
            maze[xl + 1, yh] = 0
            doors += 1
        if doors == 0:
            maze[xl + 1, int(rng.integers(yl, yh + 1))] = 0
    elif xl < xh - 2 and yl < yh - 1:      # transposed 3-wide chamber
        maze[xl:xh + 1, yl + 1] = 1
        doors = 0
        if xl - 1 >= 0 and maze[xl - 1, yl + 1] == 0:
            maze[xl, yl + 1] = 0
            doors += 1
        if xh + 1 <= maze.shape[0] - 1 and maze[xh + 1, yl + 1] == 0:
            maze[xh, yl + 1] = 0
            doors += 1
        if doors == 0:
            maze[int(rng.integers(xl, xh + 1)), yl + 1] = 0
    elif xl < xh - 1 and yl < yh - 1:      # 3×3: single center block
        maze[xl + 1, yl + 1] = 1


def maze2d(size=(40, 40, 15), res=0.5, seed=0, road_width=1.0,
           add_wall_x=True, add_wall_y=True):
    """Recursive-division 2-D maze extruded to full height (mockamap type 3,
    ref maps.cpp maze2D:604-676 + recursiveDivision:180-498).  Cells of
    `road_width` metres; occupied cells become full-height voxel columns.
    Returns occupied voxel centers (M, 3)."""
    rng = np.random.default_rng(seed)
    sx, sy, sz = size
    mx = max(int(sx * res / road_width), 4)
    my = max(int(sy * res / road_width), 4)
    maze = np.zeros((mx, my), np.int8)
    _recursive_division(maze, 0, mx - 1, 0, my - 1, rng)
    if add_wall_x:
        maze[:, 0] = 1
        maze[:, -1] = 1
    if add_wall_y:
        maze[0, :] = 1
        maze[-1, :] = 1
    cells_per = max(int(round(road_width / res)), 1)
    occ = np.kron(maze, np.ones((cells_per, cells_per), np.int8))
    occ = occ[:sx, :sy]
    ij = np.argwhere(occ > 0)
    k = np.arange(sz)
    pts = np.concatenate([
        np.repeat(ij, sz, axis=0),
        np.tile(k, ij.shape[0])[:, None],
    ], axis=1)
    return (pts + 0.5) * res


def maze3d(size=(40, 40, 15), res=0.5, seed=0, num_nodes=10,
           connectivity=0.5, road_rad=2):
    """3-D Voronoi-wall maze (mockamap type 4, ref maps.cpp Maze3DGen:
    779-893): random cores partition space; voxels near the bisector
    surface between their two nearest cores become walls, except "holed
    walls" (core-index pairs inside the connectivity band) which open a
    corridor where the two-core distance sum stays near the straight-line
    distance.  Vectorized over the whole grid.  Returns (M, 3) points."""
    rng = np.random.default_rng(seed)
    sx, sy, sz = size
    cores = rng.uniform(0.0, 1.0, size=(num_nodes, 3)) * \
        (np.array(size) * res) - np.array(size) * res / 2.0
    ii = np.stack(np.meshgrid(np.arange(sx), np.arange(sy), np.arange(sz),
                              indexing="ij"), axis=-1).reshape(-1, 3)
    pts = ii * res - np.array(size) * res / 2.0
    d = np.linalg.norm(pts[:, None, :] - cores[None, :, :], axis=-1)
    order = np.argsort(d, axis=1)
    i1, i2 = order[:, 0], order[:, 1]
    d1 = np.take_along_axis(d, i1[:, None], axis=1)[:, 0]
    d2 = np.take_along_axis(d, i2[:, None], axis=1)[:, 0]
    on_wall = np.abs(d2 - d1) < res
    pair_sum = i1 + i2
    holed = (pair_sum > int((1 - connectivity) * num_nodes)) & \
        (pair_sum < int((1 + connectivity) * num_nodes))
    core_gap = np.linalg.norm(cores[i1] - cores[i2], axis=-1)
    keep_hole = (d1 + d2 - core_gap) >= road_rad * res / 3.0
    occupied = on_wall & (~holed | keep_hole)
    return pts[occupied] + np.array(size) * res / 2.0


# --- 2-D planar maps (for the paper's 2-D experiments; no reference
# equivalent — the reference repo ships no 2-D code path) -------------------

def planar_forest(res=0.25, seed=0, trees=26, area=30.0):
    """Random disc obstacles in a square arena, boundary ring included.
    Returns (M, 2) points."""
    rng = np.random.default_rng(seed)
    pts = []
    for _ in range(trees):
        c = rng.uniform(4.0, area - 4.0, size=2)
        if np.linalg.norm(c - np.array([2.0, 2.0])) < 3.0:
            continue
        if np.linalg.norm(c - np.array([area - 2.0, area - 2.0])) < 3.0:
            continue
        r = rng.uniform(0.5, 1.4)
        th = np.arange(0, 2 * np.pi, res / max(r, res))
        for rr in np.arange(res / 2, r, res):
            pts.append(np.stack([c[0] + rr * np.cos(th),
                                 c[1] + rr * np.sin(th)], -1))
    for t in np.arange(0, area, res):
        pts.append(np.array([[t, 0.0], [t, area], [0.0, t], [area, t]]))
    return np.concatenate(pts, axis=0)


def planar_gaps(res=0.25, area=24.0, gap=2.2, walls=(8.0, 16.0)):
    """Two full-height walls with offset narrow gaps — the polygon-with-yaw
    scenario: a long bar must turn to slide through.  Returns (M, 2)."""
    pts = []
    ys = np.arange(0.0, area + 1e-9, res)
    for i, wx in enumerate(walls):
        gc = area * (0.35 if i % 2 == 0 else 0.65)
        keep = np.abs(ys - gc) > gap / 2
        for dx in np.arange(0.0, 0.75, res):
            pts.append(np.stack(
                [np.full(keep.sum(), wx + dx), ys[keep]], -1))
    for t in np.arange(0, area, res):
        pts.append(np.array([[t, 0.0], [t, area], [0.0, t], [area, t]]))
    return np.concatenate(pts, axis=0)
