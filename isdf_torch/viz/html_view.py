"""Self-contained interactive HTML 3-D viewer in the RViz / debug-GUI role
(counterpart of ``isdf_tpu/viz/html_view.py``; ref src/utils/include/utils/
Visualization.hpp:258-1178 marker factory + src/debug_assistant/scripts/
main.py pygame loop).

Writes ONE .html file with an embedded vanilla-JS canvas renderer (no
three.js / CDN / network): orbit (drag), zoom (wheel), pan (shift-drag),
toggleable layers.  Layers supported:
  * point clouds (map voxels, obstacle points) — size/color per layer
  * polylines (trajectory, A* path)
  * triangle meshes (swept volume, robot body) — flat-shaded painter sort
  * pose triads (position + R columns as RGB axes)

Geometry is embedded as JSON, numbers rounded to 4 decimals; the page
template is the JAX package's.  Host-only: tensors are read to numpy.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ margin:0; background:#10141a; color:#cfd8e3; font:13px sans-serif; }}
 #hud {{ position:fixed; top:8px; left:8px; background:#1a2129cc;
        padding:8px 10px; border-radius:6px; }}
 #hud label {{ display:block; cursor:pointer; }}
 canvas {{ display:block; }}
</style></head><body>
<div id="hud"><b>{title}</b><div id="layers"></div>
<div style="opacity:.6;margin-top:4px">drag: orbit &middot; wheel: zoom
&middot; shift-drag: pan</div></div>
<canvas id="c"></canvas>
<script>
const DATA = {data};
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H; const resize = () => {{ W = cv.width = innerWidth;
  H = cv.height = innerHeight; }}; resize(); onresize = () => {{ resize();
  draw(); }};
let yaw = 0.7, pitch = 0.5, dist = DATA.radius * 2.6,
    cx = DATA.center[0], cy = DATA.center[1], cz = DATA.center[2];
let px = 0, py = 0, drag = 0, shift = 0;
cv.onmousedown = e => {{ drag = 1; shift = e.shiftKey; px = e.clientX;
  py = e.clientY; }};
onmouseup = () => drag = 0;
onmousemove = e => {{ if (!drag) return;
  const dx = e.clientX - px, dy = e.clientY - py; px = e.clientX;
  py = e.clientY;
  if (shift) {{ const s = dist / 600;
    const [rx, ry] = [Math.cos(yaw), Math.sin(yaw)];
    cx -= s * (dx * -ry); cy -= s * (dx * rx); cz += s * dy;
  }} else {{ yaw -= dx * 0.008; pitch += dy * 0.008;
    pitch = Math.max(-1.55, Math.min(1.55, pitch)); }}
  draw(); }};
cv.onwheel = e => {{ dist *= Math.exp(e.deltaY * 0.001); draw();
  e.preventDefault(); }};

function proj(p) {{
  const sy = Math.sin(yaw), cyw = Math.cos(yaw),
        sp = Math.sin(pitch), cp = Math.cos(pitch);
  const x = p[0] - cx, y = p[1] - cy, z = p[2] - cz;
  const x1 = cyw * x + sy * y, y1 = -sy * x + cyw * y;
  const y2 = cp * y1 + sp * z, z2 = -sp * y1 + cp * z;
  const d = dist + x1;
  if (d < 0.05) return null;
  const f = (0.9 * Math.min(W, H)) / d;
  return [W / 2 + f * y2, H / 2 - f * z2, d, f];
}}

const enabled = {{}};
const hud = document.getElementById('layers');
for (const L of DATA.layers) {{
  enabled[L.name] = true;
  const lab = document.createElement('label');
  const cb = document.createElement('input'); cb.type = 'checkbox';
  cb.checked = true;
  cb.onchange = () => {{ enabled[L.name] = cb.checked; draw(); }};
  lab.appendChild(cb);
  lab.appendChild(document.createTextNode(' ' + L.name));
  lab.style.color = L.color;
  hud.appendChild(lab);
}}

function draw() {{
  ctx.fillStyle = '#10141a'; ctx.fillRect(0, 0, W, H);
  const tris = [];
  for (const L of DATA.layers) {{
    if (!enabled[L.name]) continue;
    if (L.kind === 'points') {{
      ctx.fillStyle = L.color;
      const r = L.size || 1.5;
      for (const p of L.pts) {{
        const q = proj(p); if (!q) continue;
        const s = Math.max(0.5, r * q[3] * 0.01);
        ctx.fillRect(q[0] - s / 2, q[1] - s / 2, s, s);
      }}
    }} else if (L.kind === 'line') {{
      ctx.strokeStyle = L.color; ctx.lineWidth = L.size || 2;
      ctx.beginPath();
      let first = true;
      for (const p of L.pts) {{
        const q = proj(p); if (!q) {{ first = true; continue; }}
        if (first) {{ ctx.moveTo(q[0], q[1]); first = false; }}
        else ctx.lineTo(q[0], q[1]);
      }}
      ctx.stroke();
    }} else if (L.kind === 'mesh') {{
      for (const t of L.tris) {{
        const a = proj(t[0]), b = proj(t[1]), c = proj(t[2]);
        if (!a || !b || !c) continue;
        const depth = (a[2] + b[2] + c[2]) / 3;
        // flat shade by screen-space normal orientation
        const nz = (b[0] - a[0]) * (c[1] - a[1])
                 - (b[1] - a[1]) * (c[0] - a[0]);
        tris.push([depth, a, b, c, L.color, nz]);
      }}
    }} else if (L.kind === 'poses') {{
      for (const t of L.triads) {{
        const o = proj(t[0]); if (!o) continue;
        const cols = ['#e05555', '#55c155', '#5588e0'];
        for (let i = 0; i < 3; i++) {{
          const q = proj(t[1 + i]); if (!q) continue;
          ctx.strokeStyle = cols[i]; ctx.lineWidth = 1.5;
          ctx.beginPath(); ctx.moveTo(o[0], o[1]); ctx.lineTo(q[0], q[1]);
          ctx.stroke();
        }}
      }}
    }}
  }}
  tris.sort((u, v) => v[0] - u[0]);
  for (const [d, a, b, c, col, nz] of tris) {{
    const shade = 0.45 + 0.4 * Math.min(1, Math.abs(nz) /
      (0.0001 + 0.5 * (Math.abs(a[3]) + 1) * 900));
    ctx.fillStyle = col;
    ctx.globalAlpha = Math.max(0.25, Math.min(0.85, shade));
    ctx.beginPath(); ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]);
    ctx.lineTo(c[0], c[1]); ctx.closePath(); ctx.fill();
  }}
  ctx.globalAlpha = 1.0;
}}
draw();
</script></body></html>
"""


class HtmlScene:
    """Accumulates layers, then writes one self-contained HTML file."""

    def __init__(self, title: str = "isdf_torch scene"):
        self.title = title
        self.layers = []
        self._all_pts = []

    def add_points(self, name: str, pts, color: str = "#8fa7bf",
                   size: float = 1.5, max_points: int = 120000):
        pts = np.asarray(pts, np.float64).reshape(-1, 3)
        if len(pts) > max_points:
            idx = np.linspace(0, len(pts) - 1, max_points).astype(int)
            pts = pts[idx]
        self.layers.append(dict(kind="points", name=name, color=color,
                                size=size, pts=_r(pts)))
        self._all_pts.append(pts)

    def add_line(self, name: str, pts, color: str = "#f0b429",
                 width: float = 2.0):
        pts = np.asarray(pts, np.float64).reshape(-1, 3)
        self.layers.append(dict(kind="line", name=name, color=color,
                                size=width, pts=_r(pts)))
        self._all_pts.append(pts)

    def add_mesh(self, name: str, vertices, faces, color: str = "#4d9de0",
                 max_tris: int = 40000):
        V = np.asarray(vertices, np.float64).reshape(-1, 3)
        F = np.asarray(faces, np.int64).reshape(-1, 3)
        if len(F) > max_tris:
            idx = np.linspace(0, len(F) - 1, max_tris).astype(int)
            F = F[idx]
        tris = V[F]                                     # (T, 3, 3)
        self.layers.append(dict(kind="mesh", name=name, color=color,
                                tris=[_r(t) for t in tris]))
        self._all_pts.append(V)

    def add_poses(self, name: str, positions, rotations,
                  axis_len: float = 0.4):
        X = np.asarray(positions, np.float64).reshape(-1, 3)
        R = np.asarray(rotations, np.float64).reshape(-1, 3, 3)
        triads = []
        for x, r in zip(X, R):
            triads.append(_r(np.stack(
                [x, x + axis_len * r[:, 0], x + axis_len * r[:, 1],
                 x + axis_len * r[:, 2]])))
        self.layers.append(dict(kind="poses", name=name, triads=triads,
                                color="#cccccc"))
        self._all_pts.append(X)

    def write(self, path: str) -> str:
        if self._all_pts:
            allp = np.concatenate(self._all_pts, axis=0)
            center = allp.mean(axis=0)
            radius = float(
                max(np.linalg.norm(allp - center, axis=1).max(), 1.0))
        else:
            center, radius = np.zeros(3), 5.0
        data = dict(layers=self.layers,
                    center=[round(float(c), 3) for c in center],
                    radius=round(radius, 3))
        html = _HTML.format(title=self.title,
                            data=json.dumps(data, separators=(",", ":")))
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write(html)
        return path


def _r(a):
    return [[round(float(v), 4) for v in row] for row in np.asarray(a)]


def export_plan_view(path, pm=None, res=None, gridmap=None, traj=None,
                     swept=None, shape=None, params=None,
                     n_pose_triads: int = 12, title: str = "isdf_torch plan"):
    """One-call scene export for a finished plan.

    pm/res: PlannerManager + PlanResult (preferred — pulls map, path, traj);
    or pass gridmap/traj directly.  swept: optional (V, F) swept-volume mesh
    from viz.swept_mesh.  Returns the written path.
    """
    from isdf_torch.sweep.sweep_sdf import traj_states

    sc = HtmlScene(title)
    gm = gridmap if gridmap is not None else (
        pm.gridmap if pm is not None else None)
    if gm is not None:
        occ = np.asarray(gm.occupied_centers())
        sc.add_points("map voxels", occ, color="#8fa7bf", size=2.0)
    if res is not None and getattr(res, "path", None) is not None:
        sc.add_line("A* path", np.asarray(res.path), color="#7bd389",
                    width=1.5)
    tr = traj if traj is not None else (
        res.traj if res is not None else None)
    if tr is not None:
        tr = tr.detach()
        dur = tr.durations
        total = float(tr.total_duration)
        with torch.no_grad():
            ts = torch.linspace(0.0, total, 400, dtype=dur.dtype,
                                device=dur.device)
            sc.add_line("trajectory", tr.pos(ts).cpu().numpy(),
                        color="#f0b429", width=2.5)
            if params is not None:
                tt = torch.linspace(0.0, total, n_pose_triads,
                                    dtype=dur.dtype, device=dur.device)
                xs, Rs = traj_states(tr, params, tt)
                sc.add_poses("poses", xs.cpu().numpy(), Rs.cpu().numpy())
    if swept is not None:
        V, F = swept
        sc.add_mesh("swept volume", V, F, color="#4d9de0")
    return sc.write(path)
