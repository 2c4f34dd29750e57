"""Single plans back to back in a closed loop, one client:
``PlannerManager.plan`` on the configuration's map, from start to goal
pairs near its documented endpoints.  The pool of pairs is the traffic's
(drawn once from its own seed, so every run plans the same set); the run's
seed orders it.  A plan may start while fewer than ``seconds`` have
passed; the one in flight finishes and counts.  ``plan_s`` is the time from
the first plan's start to the last one's end over the plans attempted."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import program, trace
from benchmark.reference import gather
from benchmark.reference import traj as rt
from benchmark.reference.judge import Judge, control_answers
from benchmark.reference.occupancy import Occupancy

PHASES = ("front_end_s", "mid_end_s", "back_end_s", "audit_s")


def pool(config: dict, traffic: dict, occ: Occupancy) -> list:
    """The traffic's start and goal pairs: free voxels within
    ``radius`` of the configuration's documented endpoints."""
    rng = np.random.default_rng(traffic["pool_seed"])
    ends = config["endpoints"]

    def near(p):
        p = np.asarray(p, dtype=np.float64)
        while True:
            d = rng.normal(size=3)
            q = p + d / np.linalg.norm(d) * traffic["radius"] \
                * rng.uniform() ** (1 / 3)
            if occ.free_center(q):
                return q
    return [(near(ends["start"]), near(ends["goal"]))
            for _ in range(traffic["pool"])]


def setup(ctx):
    from isdf_torch.plan import PlannerManager
    from isdf_torch.world import GridMap

    conf, shape = program.build(ctx.config, ctx.device)
    cloud = program.cloud(ctx.config)
    pm = PlannerManager(conf, shape=shape, device=ctx.device)
    pm.set_map(GridMap.from_points(cloud, None, conf.occupancy_resolution,
                                   conf.sta_threshold, device=ctx.device))
    occ = Occupancy(cloud, conf.occupancy_resolution, conf.sta_threshold)
    pairs = pool(ctx.config, ctx.traffic, occ)
    order = np.random.default_rng(ctx.seed).permutation(len(pairs))
    # warm-up: one plan with its solves capped builds and loads every
    # kernel and the host paths
    ends = ctx.config["endpoints"]
    solves = _Solves()
    with solves:
        pm.plan(np.asarray(ends["start"], float),
                np.asarray(ends["goal"], float),
                max_iters=ctx.traffic["warm_iters"])
    if not solves.calls:
        raise RuntimeError(
            "benchmark: the warm-up plan made no call to isdf_torch.opt."
            "backend.optimize, where the plan check reads each back-end "
            "solve's start and obstacle points")
    solves.calls.clear()
    return dict(pm=pm, pairs=[pairs[i] for i in order], cloud=cloud, occ=occ,
                solves=solves)


class _Solves:
    """Records the arguments of each back-end solve (the program's
    ``isdf_torch.opt.backend.optimize``, which ``PlannerManager.plan``
    looks up on its module at each call): its start and its obstacle
    points, the program's state that the check follows.  Installed once
    around set-up's warm-up plan and once around the window, outside the
    timed loop; a warm-up plan that records no solve stops the run at
    set-up, naming this dependency."""

    def __init__(self):
        self.calls = []
        from isdf_torch.opt import backend
        self.mod, self.fn = backend, backend.optimize

    def __enter__(self):
        calls, fn = self.calls, self.fn

        def rec(shape, conf, head, tail, q0, T0, points, mask, *a, **k):
            calls.append((head, tail, q0, T0, points, mask))
            return fn(shape, conf, head, tail, q0, T0, points, mask, *a, **k)
        self.mod.optimize = rec
        return self

    def __exit__(self, *exc):
        self.mod.optimize = self.fn


def window(ctx, st):
    pm, pairs = st["pm"], st["pairs"]
    plans, results = [], []
    records = {"plans": plans, "config": ctx.config}
    rec = trace.SweepRecorder() if ctx.trace else None

    calls = st["solves"].calls

    def plan(i):
        start, goal = pairs[i % len(pairs)]
        n0 = len(calls)
        t0 = time.perf_counter()
        res = pm.plan(start, goal)
        ctx.sync()
        wall = time.perf_counter() - t0
        m = res.metrics
        plans.append(dict({k: m.get(k, 0.0) for k in PHASES}, wall_s=wall,
                          back_end_evals=m.get("back_end_evals", 0)))
        results.append((res, (n0, len(calls))))

    with st["solves"]:
        t_start = time.perf_counter()
        i = 0
        if ctx.trace:           # the first plans under the profiler
            with rec.active(), trace.profiled(records):
                for _ in range(ctx.traffic["profiled"]):
                    plan(i)
                    i += 1
            records["sweeps"] = rec.calls()
            records["profiled_plans"] = i
        while time.perf_counter() - t_start < ctx.seconds:
            plan(i)
            i += 1
        t_end = time.perf_counter()
    results = [(res, calls[a:b]) for res, (a, b) in results]
    return {"attempted": len(results), "results": results,
            "records": records, "walls": [p["wall_s"] for p in plans],
            "e2e": {"plan_s": (t_end - t_start) / len(results)}}


def answers(ctx, st, win):
    """Each plan's answer on the host, and the program's audit of it."""
    pm = st["pm"]
    out = []
    for res, calls in win["results"]:
        a = {"success": bool(res.success)}
        if res.success:
            traj = res.traj
            a["audit"] = float(pm.audit_collision(traj))
            a["c"] = traj.coeffs.double().cpu().numpy()
            a["T"] = traj.durations.double().cpu().numpy()
            a["f"] = float(res.metrics["final_cost"])
            a["path"] = np.asarray(res.path, dtype=np.float64)
            a["solves"] = [tuple(np.asarray(torch.as_tensor(x).cpu(),
                                            dtype=np.float64)
                                 for x in call) for call in calls]
        out.append(a)
    return {"plans": out, "cloud": st["cloud"], "occ": st["occ"]}


def readings(ctx, a, device) -> tuple:
    """(the compared numbers, plans failed) of the window's plans."""
    s = ctx.config["settings"]
    j = Judge(ctx.config, device)
    occ = a["occ"]
    half = s["kernel_size"] * s["occupancy_resolution"] / 2
    gaps = {"coef_gap": 0.0, "clearance_gap": 0.0, "not_descended": 0.0,
            "grad_ratio": 0.0, "gather_gap": 0}
    rel = []
    failed, done = 0, 0
    for p in a["plans"]:
        if not p["success"] or not np.isfinite(p["f"]) \
                or not np.all(np.isfinite(p["c"])) or p["audit"] <= 0.0:
            failed += 1
            continue
        done += 1
        c, T = p["c"][None], p["T"][None]
        head, tail, q0, T0, pts0, mask0 = p["solves"][0]
        _, _, _, _, pts, mask = p["solves"][-1]
        mask, mask0 = mask.astype(bool), mask0.astype(bool)
        ans = dict(head=head[None], tail=tail[None], c=c, T=T,
                   f=np.array([p["f"]]))
        # the last solve's problem, from the back end's first start
        last = j.readings(dict(ans, pts=pts[None], mask=mask[None],
                               q0=q0[None], T0=T0[None]))
        first = j.readings(dict(ans, pts=pts0[None], mask=mask0[None],
                                q0=q0[None], T0=T0[None]))
        # the first solve's obstacle points are the reference's own gather
        # from the plan's path; a safety re-plan's added points are
        # occupied voxel centres of the reference's map, or the cost
        # cannot be judged
        own = gather.obstacle_points(occ, p["path"], s, ctx.config["gather"])
        gaps["gather_gap"] = max(gaps["gather_gap"],
                                 gather.set_gap(occ, own, pts0[mask0]))
        off = occ.off_grid(pts[mask])
        rel.append(float(last["cost_rel"][0]) if off == 0 else float("inf"))
        ct, Tt = j.t(c[0]), j.t(T[0])
        ts = torch.linspace(0.0, 1.0, 64, dtype=ct.dtype,
                            device=ct.device) * Tt.sum()
        pos = rt.at_times(ct, Tt, ts)[0].cpu().numpy()
        near = occ.near(pos, half)
        clr = j.clearance(ct, Tt, j.t(near))
        gaps["coef_gap"] = max(gaps["coef_gap"], float(last["coef_gap"][0]))
        gaps["clearance_gap"] = max(gaps["clearance_gap"],
                                    abs(p["audit"] - clr))
        gaps["not_descended"] += float(not bool(first["descended"][0]))
        gaps["grad_ratio"] = max(gaps["grad_ratio"],
                                 float(last["grad_ratio"][0]))
    if not done:
        return {k: float("inf") for k in ctx.limits}, failed
    gaps["not_descended"] /= done
    gaps["cost_gap"] = float(np.max(np.abs(rel)))
    return gaps, failed


def check(ctx, a):
    return readings(ctx, a, ctx.device)


def control(ctx, a):
    """The control's readings: each plan's trajectory, cost and audit
    clearance computed by the reference in bfloat16 in the program's
    place."""
    s = ctx.config["settings"]
    half = s["kernel_size"] * s["occupancy_resolution"] / 2
    low = Judge(ctx.config, ctx.device, torch.bfloat16)
    plans = []
    for p in a["plans"]:
        if not p.get("success") or "c" not in p:
            plans.append(p)
            continue
        head, tail, _, _, pts, mask = p["solves"][-1]
        ca = control_answers(ctx.config, dict(
            head=head[None], tail=tail[None], c=p["c"][None],
            T=p["T"][None], f=np.array([p["f"]]), pts=pts[None],
            mask=mask.astype(bool)[None]), ctx.device)
        c, T = low.t(ca["c"][0]), low.t(ca["T"][0])
        ts = torch.linspace(0.0, 1.0, 64, dtype=c.dtype,
                            device=c.device) * T.sum()
        pos = rt.at_times(c, T, ts)[0].float().cpu().numpy()
        near = a["occ"].near(pos, half)
        plans.append(dict(p, c=ca["c"][0].numpy(), T=ca["T"][0].numpy(),
                          f=float(ca["f"][0]),
                          audit=low.clearance(c, T, low.t(near))))
    return readings(ctx, dict(a, plans=plans), ctx.device)[0]
