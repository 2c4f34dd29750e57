"""Exports in place of the reference's RViz marker factory (counterpart of
``isdf_tpu/viz/export.py``; ref utils/Visualization.hpp): OBJ meshes
(swept volumes, robot bodies) and trajectory CSVs for external viewers, in
the JAX package's number formats."""

from __future__ import annotations

import numpy as np
import torch

from isdf_torch.sweep.sweep_sdf import sdf_at_time


def export_obj(path: str, tris: np.ndarray):
    """Write a triangle soup (T, 3, 3) as an OBJ file."""
    with open(path, "w") as f:
        f.write("# isdf_torch export\n")
        for tri in tris:
            for v in tri:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for i in range(len(tris)):
            b = 3 * i
            f.write(f"f {b+1} {b+2} {b+3}\n")


def export_traj_csv(path: str, traj, n: int = 500):
    ts = np.linspace(0.0, float(traj.total_duration), n)
    dur = traj.durations
    with torch.no_grad():
        pos, vel, _, _ = traj.pvaj(torch.as_tensor(ts, dtype=dur.dtype,
                                                   device=dur.device))
    pos, vel = pos.cpu().numpy(), vel.cpu().numpy()
    with open(path, "w") as f:
        f.write("t,x,y,z,vx,vy,vz\n")
        for t, p, v in zip(ts, pos, vel):
            f.write(f"{t:.4f},{p[0]:.5f},{p[1]:.5f},{p[2]:.5f},"
                    f"{v[0]:.5f},{v[1]:.5f},{v[2]:.5f}\n")


def sdf_time_curve(shape, traj, params, point, n: int = 512):
    """SDF(t) of the body at one fixed world point over the whole
    trajectory (the sdf_vis topic's payload; ref src/sdf_vis/scripts/
    main.py) → (ts (n,), sdf (n,)) as NumPy arrays.  One call of
    ``sdf_at_time``: its einsum broadcasts the point over the n times."""
    dur = traj.durations
    ts = torch.linspace(0.0, float(traj.total_duration), n, dtype=dur.dtype,
                        device=dur.device)
    p = torch.as_tensor(np.asarray(point, np.float64), dtype=dur.dtype,
                        device=dur.device)
    with torch.no_grad():
        d = sdf_at_time(shape, traj.detach(), params, p, ts)
    return ts.cpu().numpy(), d.cpu().numpy()


def export_sdf_curve_csv(path: str, shape, traj, params, point,
                         n: int = 512):
    ts, sdf = sdf_time_curve(shape, traj, params, point, n)
    with open(path, "w") as f:
        f.write("t,sdf\n")
        for t, d in zip(ts, sdf):
            f.write(f"{t:.5f},{d:.6f}\n")
