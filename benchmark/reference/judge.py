"""What decides ``correct``: the answers the program returned, held against
the reference's own computation of the same quantities.

For each returned trajectory (coefficients c and durations T, the reported
cost f, the obstacle points the cost was taken over):

* ``coef_gap``: max |c - c_ref| / max |c_ref|, c_ref the minimum-jerk
  trajectory through the answer's own waypoints and durations;
* ``cost_rel``: (f - f_ref) / |f_ref|, f_ref the reference's cost of the
  answer's trajectory, its swept SDF found by brute force.  The program's
  sweep scans ``sweep_coarse_samples`` times and zooms into the best (warm
  or coarse) basin, so where it misses a point's deepest basin its swept
  SDF reads high and its cost low; float32 rounding moves it either way.
  Over a batch's many answers the drivers compare the largest excess,
  max (f - f_ref) / |f_ref|, and the median of |f - f_ref| / |f_ref|; over
  a few plans, the largest |f - f_ref| / |f_ref|;
* ``descended``: whether f_ref lies below the reference's cost of the
  solve's start, on the same points;
* ``grad_ratio``: |grad f_ref| at the answer over |grad f_ref| at the
  solve's start, in the solve's variables (interior waypoints and
  durations), by autograd in float64: how far the answer is from a
  stationary point, which an answer cut short, a weaker line search or a
  wrong sweep gradient leaves farther;
* for a plan, ``clearance_gap``: |the audit's clearance - the reference's
  minimum swept SDF over the occupied voxels near the trajectory|.

The control (``control_answers``) puts the reference in the program's
place, computed in bfloat16, the precision below the configuration's
float32: its answers must fail these comparisons.
"""

from __future__ import annotations

import torch

from benchmark.reference import bodies
from benchmark.reference import sweep as rs
from benchmark.reference import traj as rt

F64 = torch.float64


def weights(s: dict) -> dict:
    keys = ("rho", "weight_v", "weight_omg", "weight_theta", "weight_p",
            "vmax", "omgmax", "thetamax", "safety_hor", "smoothingEps")
    return {k: float(s[k]) for k in keys}


def physics(s: dict) -> dict:
    return dict(mass=float(s["vehicleMass"]), grav=float(s["gravAcc"]),
                dh=float(s["horizDrag"]), cp=float(s["parasDrag"]),
                veps=float(s["speedEps"]))


class Judge:
    """The reference of one configuration, in ``dtype`` on ``device``."""

    def __init__(self, config: dict, device, dtype=F64):
        s = config["settings"]
        self.dtype, self.device = dtype, device
        self.w, self.phys = weights(s), physics(s)
        self.res = int(s["integralIntervs"])
        self.body = bodies.make(config["body"], s, dtype, device)

    def t(self, a, dtype=None):
        return torch.as_tensor(a).to(dtype=dtype or self.dtype,
                                     device=self.device)

    def cost(self, c, T, pts, mask):
        """The back end's cost of trajectories (K, N) over points (K, P)."""
        sv, _ = rs.swept_sdf(self.body, c, T, pts, self.phys)
        return rt.cost_terms(c, T, sv, mask, self.w, self.phys, self.res)

    def clearance(self, c, T, pts):
        """The least swept SDF of one trajectory over points (P, 3)."""
        if len(pts) == 0:
            return float("inf")
        sv, _ = rs.swept_sdf(self.body, c[None], T[None], pts[None],
                             self.phys)
        return float(sv.min())

    def grad_norm(self, q, T, head, tail, pts, mask):
        """|grad f| of the back end's cost at interior waypoints q (K, N-1,
        3) and durations T (K, N), over (q, T).  The swept SDF is taken at
        its minimizing times, held fixed: the minimum's derivative is the
        integrand's at the minimizer."""
        with torch.no_grad():
            c0 = rt.minco(q, T, head, tail)
            _, ts = rs.swept_sdf(self.body, c0, T, pts, self.phys)
        with torch.enable_grad():
            qg = q.detach().requires_grad_(True)
            Tg = T.detach().requires_grad_(True)
            c = rt.minco(qg, Tg, head, tail)
            sv = rs.sdf_at(self.body, c, Tg, pts, ts, self.phys)
            f = rt.cost_terms(c, Tg, sv, mask, self.w, self.phys, self.res)
            gq, gT = torch.autograd.grad(f.sum(), (qg, Tg))
        return torch.sqrt(gq.flatten(1).square().sum(1) + gT.square().sum(1))

    def readings(self, ans: dict, block: int = 16) -> dict:
        """Per answer: coef_gap, cost_rel, f_ref and (with the solve's start
        q0, T0) descended and grad_ratio.  ``ans`` holds head, tail (K, 3,
        3), c, T, f, pts (K, P, 3), mask and optionally q0, T0."""
        out = {"coef_gap": [], "cost_rel": [], "f_ref": [], "descended": [],
               "grad_ratio": []}
        K = len(ans["T"])
        for k0 in range(0, K, block):
            a = {k: self.t(v[k0:k0 + block], torch.bool if k == "mask"
                           else None) for k, v in ans.items()}
            c_ref = rt.minco(rt.waypoints(a["c"]), a["T"], a["head"],
                             a["tail"])
            scale = c_ref.abs().flatten(1).max(1).values
            out["coef_gap"].append(
                (a["c"] - c_ref).abs().flatten(1).max(1).values / scale)
            f_ref = self.cost(a["c"], a["T"], a["pts"], a["mask"])
            out["f_ref"].append(f_ref)
            out["cost_rel"].append((a["f"] - f_ref) / f_ref.abs())
            if "q0" in a:
                c0 = rt.minco(a["q0"], a["T0"], a["head"], a["tail"])
                f0 = self.cost(c0, a["T0"], a["pts"], a["mask"])
                out["descended"].append(f_ref < f0)
                g = self.grad_norm(rt.waypoints(a["c"]), a["T"], a["head"],
                                   a["tail"], a["pts"], a["mask"])
                g0 = self.grad_norm(a["q0"], a["T0"], a["head"], a["tail"],
                                    a["pts"], a["mask"])
                out["grad_ratio"].append(g / g0)
        return {k: torch.cat(v).cpu() for k, v in out.items() if v}


def control_answers(config: dict, ans: dict, device) -> dict:
    """The reference in the program's place, in bfloat16: the trajectory
    through the answer's waypoints and durations and its cost, each
    computed in bfloat16 (the minimum-jerk system solved in float32, which
    is the least the solver takes, and rounded)."""
    ctl = Judge(config, device, torch.bfloat16)
    out = dict(ans)
    cs, fs = [], []
    K = len(ans["T"])
    for k0 in range(0, K, 16):
        a = {k: ctl.t(v[k0:k0 + 16], torch.bool if k == "mask" else None)
             for k, v in ans.items() if k not in ("q0", "T0")}
        c = rt.minco(rt.waypoints(a["c"]), a["T"], a["head"], a["tail"])
        cs.append(c)
        fs.append(ctl.cost(c, a["T"], a["pts"], a["mask"]))
    out["T"] = torch.as_tensor(ans["T"]).to(torch.bfloat16).to(F64)
    out["c"] = torch.cat(cs).to(F64).cpu()
    out["f"] = torch.cat(fs).to(F64).cpu()
    return out
