"""Live in-flight viewer in the odom_visualization / rviz_plugins role
(counterpart of ``isdf_tpu/viz/live_view.py``; ref src/odom_visualization +
src/rviz_plugins: pose/velocity/path markers streamed while the drone
flies).

A self-contained localhost HTTP viewer (no dependencies, no egress): a
background thread serves one HTML page whose JS polls ``/state.json`` a few
times a second and draws

  * the map point cloud (top-down x–y and side x–z projections),
  * the latest planned trajectory polyline,
  * the drone pose trail + heading, and
  * a live metrics strip (t, speed, min body-SDF, replan wall time).

Clicking either canvas posts a new goal back to the producer — the
``rviz_plugins`` *3D Nav Goal* affordance (ref src/common/rviz_plugins):
the click's canvas position is inverse-projected to world x–y (top view)
or x–z (side view), the missing coordinate is kept from the current goal,
and the result is POSTed to ``/goal``.  Consumers either pass ``on_goal=``
(push: called from the server thread) or poll :meth:`poll_goal` in their
flight loop.

Producers (``plan.closed_loop.fly_closed_loop`` or any loop) call
:meth:`LiveFlightView.update` with the current state; the page picks it up
on its next poll.  Everything is in memory on the host — no files written,
no sockets beyond 127.0.0.1.  :meth:`close` stops the server thread.

Usage::

    view = LiveFlightView()          # prints http://127.0.0.1:<port>
    view.set_scene(points=map_pts, goal=goal)
    ... per replan:  view.set_plan(traj_xyz)
    ... per tick:    view.update(t, pos, vel=v, min_sdf=d)
    view.close()
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>isdf_torch live flight</title>
<style>
 body { background:#10141a; color:#cdd6e4; font:13px/1.4 system-ui, sans-serif;
        margin:0; padding:14px; }
 h1 { font-size:15px; font-weight:600; margin:0 0 8px; }
 #metrics { margin:6px 0 10px; color:#8fa7bf; white-space:pre; }
 canvas { background:#161b23; border:1px solid #2a3342; border-radius:6px;
          margin-right:10px; }
</style></head><body>
<h1>isdf_torch live flight</h1>
<div id="metrics">waiting for state…</div>
<canvas id="xy" width="560" height="420"></canvas>
<canvas id="xz" width="560" height="420"></canvas>
<script>
const cv = {xy:[0,1], xz:[0,2]};
let scene = null;
let lastT = {};   // per-canvas projection, kept for click inversion
function fit(pts, axes, W, H, id) {
  let lo=[1e9,1e9], hi=[-1e9,-1e9];
  for (const p of pts) { for (let d=0; d<2; d++) {
    const v = p[axes[d]];
    if (v < lo[d]) lo[d]=v; if (v > hi[d]) hi[d]=v; } }
  const pad = 0.07;
  const sx = W*(1-2*pad)/Math.max(hi[0]-lo[0],1e-6);
  const sy = H*(1-2*pad)/Math.max(hi[1]-lo[1],1e-6);
  const s = Math.min(sx, sy);
  lastT[id] = {lo:lo, s:s, W:W, H:H, pad:pad, axes:axes};
  return p => [W*pad + (p[axes[0]]-lo[0])*s,
               H*(1-pad) - (p[axes[1]]-lo[1])*s];
}
function clickGoal(id, ev) {
  const t = lastT[id];
  if (!t || !scene) return;
  const r = ev.target.getBoundingClientRect();
  const u = ev.clientX - r.left, v = ev.clientY - r.top;
  const a = t.lo[0] + (u - t.W*t.pad)/t.s;
  const b = t.lo[1] + (t.H*(1-t.pad) - v)/t.s;
  let g = (scene.goal || [0,0,0]).slice();
  g[t.axes[0]] = a; g[t.axes[1]] = b;
  scene.goal = g;   // immediate marker feedback
  fetch("goal", {method:"POST", body:JSON.stringify(g)});
}
document.addEventListener("DOMContentLoaded", () => {
  for (const id of ["xy","xz"])
    document.getElementById(id).addEventListener(
      "click", ev => clickGoal(id, ev));
});
function draw(state) {
  if (!scene) return;
  for (const id of ["xy","xz"]) {
    const c = document.getElementById(id), g = c.getContext("2d");
    g.clearRect(0,0,c.width,c.height);
    const all = scene.points.concat(state.trail || [], [scene.goal || [0,0,0]]);
    const T = fit(all, cv[id], c.width, c.height, id);
    g.fillStyle = "#3d495c";
    for (const p of scene.points) { const q=T(p); g.fillRect(q[0],q[1],2,2); }
    if (scene.goal) { const q=T(scene.goal);
      g.strokeStyle="#57d98f"; g.lineWidth=2;
      g.beginPath(); g.arc(q[0],q[1],7,0,6.3); g.stroke(); }
    if (state.plan && state.plan.length) {
      g.strokeStyle="#f0b429"; g.lineWidth=1.5; g.beginPath();
      state.plan.forEach((p,i)=>{const q=T(p); i?g.lineTo(q[0],q[1]):g.moveTo(q[0],q[1]);});
      g.stroke(); }
    if (state.trail && state.trail.length) {
      g.strokeStyle="#4d9de0"; g.lineWidth=2; g.beginPath();
      state.trail.forEach((p,i)=>{const q=T(p); i?g.lineTo(q[0],q[1]):g.moveTo(q[0],q[1]);});
      g.stroke();
      const q=T(state.trail[state.trail.length-1]);
      g.fillStyle="#e4572e"; g.beginPath(); g.arc(q[0],q[1],5,0,6.3); g.fill(); }
  }
  const m = state.metrics || {};
  document.getElementById("metrics").textContent =
    Object.entries(m).map(([k,v])=>k+": "+(typeof v==="number"?v.toFixed(3):v)).join("   ");
}
async function tick() {
  try {
    if (!scene) scene = await (await fetch("scene.json")).json();
    draw(await (await fetch("state.json")).json());
  } catch (e) {}
  setTimeout(tick, 200);
}
tick();
</script></body></html>
"""


class LiveFlightView:
    """Localhost live flight viewer; see module docstring."""

    def __init__(self, port: int = 0, trail_len: int = 2000,
                 max_scene_points: int = 20000, quiet: bool = False,
                 on_goal=None):
        self._lock = threading.Lock()
        self._scene = {"points": [], "goal": None}
        self._state = {"trail": [], "plan": [], "metrics": {}}
        self._trail_len = trail_len
        self._max_pts = max_scene_points
        self._on_goal = on_goal
        self._clicked_goal = None
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path in ("/", "/index.html"):
                    body = _PAGE.encode()
                    ctype = "text/html"
                elif self.path == "/scene.json":
                    with outer._lock:
                        body = json.dumps(outer._scene).encode()
                    ctype = "application/json"
                elif self.path == "/state.json":
                    with outer._lock:
                        body = json.dumps(outer._state).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):  # noqa: N802 — the 3D-Nav-Goal channel
                if self.path != "/goal":
                    self.send_error(404)
                    return
                n = int(self.headers.get("Content-Length") or 0)
                try:
                    goal = [float(v) for v in json.loads(self.rfile.read(n))]
                    assert len(goal) == 3
                except Exception:
                    self.send_error(400)
                    return
                with outer._lock:
                    outer._clicked_goal = goal
                    outer._scene["goal"] = [round(v, 3) for v in goal]
                cb = outer._on_goal
                if cb is not None:   # before the response: the sender may
                    try:             # act on the ack (no post-ack race)
                        cb(np.asarray(goal))
                    except Exception:
                        pass  # a failing consumer must not kill the server
                self.send_response(204)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):  # silence per-request stderr noise
                pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}/"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        if not quiet:
            print(f"[live_view] serving {self.url}")

    # -- producers -----------------------------------------------------------
    def set_scene(self, points=None, goal=None):
        """Static scene: map point cloud (downsampled to max_scene_points)
        and goal marker."""
        with self._lock:
            if points is not None:
                pts = np.asarray(points, np.float64)
                if len(pts) > self._max_pts:
                    idx = np.linspace(0, len(pts) - 1, self._max_pts,
                                      dtype=int)
                    pts = pts[idx]
                self._scene["points"] = np.round(pts, 3).tolist()
            if goal is not None:
                self._scene["goal"] = [round(float(v), 3) for v in goal]

    def set_plan(self, traj_xyz):
        """Latest planned trajectory polyline ((K, 3) positions)."""
        with self._lock:
            self._state["plan"] = np.round(
                np.asarray(traj_xyz, np.float64), 3).tolist()

    def update(self, t: float, pos, **metrics):
        """One flight tick: append pose to the trail, refresh metrics."""
        with self._lock:
            trail = self._state["trail"]
            trail.append([round(float(v), 3) for v in np.asarray(pos)])
            if len(trail) > self._trail_len:
                del trail[: len(trail) - self._trail_len]
            m = {"t": float(t)}
            for k, v in metrics.items():
                m[k] = float(v) if isinstance(v, (int, float, np.floating)) \
                    else v
            self._state["metrics"] = m

    def poll_goal(self):
        """Return-and-clear the most recent clicked goal ((3,) ndarray or
        None) — the pull-style twin of the on_goal callback, for flight
        loops that check for operator input once per tick."""
        with self._lock:
            g = self._clicked_goal
            self._clicked_goal = None
        return None if g is None else np.asarray(g)

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2.0)
