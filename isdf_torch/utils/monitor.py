"""Live optimization observability — the debug_assistant equivalent
(counterpart of ``isdf_tpu/utils/monitor.py``).

The reference ships an interactive pygame monitor (ref
src/debug_assistant/scripts/main.py) fed by debug_publisher topics
(/debug_receive_log_cost per-iteration cost, /debug_receive_opti_step
step-through view) plus a /debug_cmd channel whose opcodes the planner
serves (ref src/plan_manager/src/plan_manager.cpp:502-585):
  21  stop optimization          → Controller.stop (utils/obs.py)
  22  pause/step optimization    → Controller.toggle_pause / step
  101 visualize zero-pose kernel → export_kernel_obj
  103 replay trajectory          → export_replay_csv

Here the live feed is the between-chunk callback of the chunked L-BFGS
solve (opt/lbfgs.py minimize_chunked — the reference's earlyExit cadence,
back_end_optimizer.hpp:888-927): each chunk yields the full CostBreakdown,
which the monitor accumulates and renders as a cost-curve artifact (PNG via
matplotlib, imported only there, or an ASCII curve for terminals).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from isdf_torch.core import flatness as fl
from isdf_torch.core.so3 import rot_to_quat


class OptiMonitor:
    """Collects per-iteration cost breakdowns during a back-end solve and
    renders them (cost-curve artifact + live terminal line).

    Pass as ``monitor=`` to backend.optimize / PlannerManager.plan /
    demos.run_demo.  An attached obs.Controller gives the reference's
    stop/pause/step affordance over the running optimization (the chunked
    solve consults it between chunks).
    """

    def __init__(self, controller=None, live: bool = False):
        self.controller = controller
        self.live = live
        self.iters: List[int] = []
        self.total: List[float] = []
        self.energy: List[float] = []
        self.time_cost: List[float] = []
        self.dyn: List[float] = []
        self.safety: List[float] = []
        self.solves = 0          # breakdown series can span several solves
        self._solve_starts: List[int] = []

    # -- feed ---------------------------------------------------------------
    def begin_solve(self):
        self.solves += 1
        self._solve_starts.append(len(self.iters))

    def on_chunk(self, it: int, bd) -> bool:
        """Record a CostBreakdown at iteration `it`; returns False to request
        early exit (stop opcode)."""
        self.iters.append(int(it))
        self.total.append(float(bd.total))
        self.energy.append(float(bd.energy))
        self.time_cost.append(float(bd.time))
        self.dyn.append(float(bd.dyn))
        self.safety.append(float(bd.safety))
        if self.live:
            print(
                f"  iter {int(it):4d}  total {float(bd.total):12.4f}  "
                f"energy {float(bd.energy):10.3f}  dyn {float(bd.dyn):10.3f}  "
                f"safety {float(bd.safety):10.3f}",
                flush=True,
            )
        if self.controller is not None:
            return self.controller.should_continue()
        return True

    # -- artifacts ----------------------------------------------------------
    def cost_curve_png(self, path: str):
        """The debug_assistant cost-curve panel as a PNG artifact."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 4.5), dpi=110)
        x = np.arange(len(self.total))
        series = [
            ("total", self.total, "#1a1a2e", 2.0),
            ("energy", self.energy, "#e63946", 1.2),
            ("time", self.time_cost, "#457b9d", 1.2),
            ("dynamic", self.dyn, "#2a9d8f", 1.2),
            ("safety", self.safety, "#f4a261", 1.2),
        ]
        for name, ys, color, lw in series:
            ax.plot(x, ys, label=name, color=color, linewidth=lw)
        for s in self._solve_starts[1:]:
            ax.axvline(s - 0.5, color="#999999", linestyle=":", linewidth=0.8)
        ax.set_yscale("symlog", linthresh=1e-2)
        ax.set_xlabel("outer iteration (chunk boundary)")
        ax.set_ylabel("cost (symlog)")
        ax.set_title("back-end optimization cost breakdown")
        ax.legend(loc="upper right", fontsize=8)
        ax.grid(alpha=0.25)
        fig.tight_layout()
        fig.savefig(path)
        plt.close(fig)
        return path

    def cost_curve_ascii(self, width: int = 64, height: int = 12) -> str:
        """Terminal cost curve (total), log-scaled — for headless terminals."""
        if not self.total:
            return "(no samples)"
        ys = np.asarray(self.total, dtype=np.float64)
        ys = np.log10(np.maximum(ys - ys.min() + 1e-9, 1e-9))
        xi = np.linspace(0, len(ys) - 1, width).round().astype(int)
        ys = ys[xi]
        lo, hi = ys.min(), ys.max()
        span = (hi - lo) or 1.0
        rows = [[" "] * width for _ in range(height)]
        for c, v in enumerate(ys):
            r = height - 1 - int((v - lo) / span * (height - 1))
            rows[r][c] = "*"
        body = "\n".join("".join(r) for r in rows)
        return (
            f"total cost: {self.total[0]:.4g} -> {self.total[-1]:.4g} "
            f"({len(self.total)} samples)\n{body}"
        )

    def summary(self) -> dict:
        return {
            "samples": len(self.total),
            "solves": self.solves,
            "total_first": self.total[0] if self.total else None,
            "total_last": self.total[-1] if self.total else None,
            "safety_last": self.safety[-1] if self.safety else None,
        }


def export_replay_csv(path: str, traj, params, fps: float = 30.0):
    """Trajectory replay export (opcode 103 — ref plan_manager.cpp:570-585
    process(traj) animated replay): one row per frame with time, position
    and the attitude quaternion [w, x, y, z] from the pose map, so any
    external viewer can animate the body along the trajectory."""
    traj = traj.detach()
    total = float(traj.total_duration)
    n = max(2, int(total * fps) + 1)
    dur = traj.durations
    ts = torch.linspace(0.0, total, n, dtype=dur.dtype, device=dur.device)
    with torch.no_grad():
        pos, vel, acc, jer = traj.pvaj(ts)
        pos3, R = fl.pose_of(pos, vel, acc, jer, params)
        quat = rot_to_quat(R)
    rows = np.column_stack(
        [a.cpu().numpy() for a in (ts, pos3, quat)])
    np.savetxt(
        path, rows, delimiter=",",
        header="t,x,y,z,qw,qx,qy,qz", comments="",
    )
    return path


def export_kernel_obj(path: str, pose_kernels, roll_idx: int = None,
                      pitch_idx: int = None, resolution: float = None):
    """Zero-pose (or chosen-pose) collision-kernel voxel visualization
    (opcode 101 equivalent — ref plan_manager.cpp:544-556 visKernel): emits
    one cube per occupied kernel voxel as an OBJ, centered at the origin."""
    kernels = pose_kernels.kernels.cpu().numpy()          # (R, P, k, k, k)
    Rn, Pn = kernels.shape[:2]
    ri = Rn // 2 if roll_idx is None else roll_idx
    pi = Pn // 2 if pitch_idx is None else pitch_idx
    k = kernels.shape[-1]
    res = resolution if resolution is not None else getattr(
        pose_kernels, "resolution", 1.0)
    occ = np.argwhere(kernels[ri, pi])
    centers = (occ - (k - 1) / 2.0) * res
    h = res / 2.0
    corners = np.array(
        [[sx, sy, sz] for sx in (-h, h) for sy in (-h, h) for sz in (-h, h)]
    )
    faces = np.array(  # quad faces of a cube, 1-indexed per-cube
        [[1, 2, 4, 3], [5, 7, 8, 6], [1, 5, 6, 2],
         [3, 4, 8, 7], [1, 3, 7, 5], [2, 6, 8, 4]]
    )
    with open(path, "w") as f:
        f.write(f"# pose kernel roll_idx={ri} pitch_idx={pi} "
                f"({len(centers)} voxels)\n")
        for i, c in enumerate(centers):
            for v in c + corners:
                f.write(f"v {v[0]:.4f} {v[1]:.4f} {v[2]:.4f}\n")
            for fc in faces + 8 * i:
                f.write(f"f {fc[0]} {fc[1]} {fc[2]} {fc[3]}\n")
    return path
