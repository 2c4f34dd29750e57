"""Batched solves back to back in a closed loop: ``parallel.batch.
batched_solve_chunked`` over a pool of scenario batches drawn from the seed
(the traffic's B, N, P, iterations and chunk), cycled.  One solve may start
while fewer than ``seconds`` have passed; the one in flight finishes and
counts.  ``plans_per_s`` is the scenarios of the solves over the time from
the first solve's start to the last one's end."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.frozen.batch_draws import draw_batch
from benchmark.harness import program, trace
from benchmark.reference.judge import Judge, control_answers

COUNTERS = (("isdf_torch.sweep.fused_zoom", "LAUNCHES_BATCHED"),
            ("isdf_torch.sweep.grid_zoom", "LAUNCHES_GRID"))


def _draws(ctx):
    tr = ctx.traffic
    seeds = np.random.SeedSequence(ctx.seed).generate_state(tr["pool"])
    return [draw_batch(ctx.config["settings"]["inittime"], tr["B"], tr["N"],
                       tr["P"], int(s)) for s in seeds]


def setup(ctx):
    from isdf_torch.parallel import batch as pb

    conf, shape = program.build(ctx.config, ctx.device)
    draws = _draws(ctx)
    batches = [pb.ScenarioBatch.from_arrays(**d, device=ctx.device)
               for d in draws]
    tr = ctx.traffic
    # warm-up: one chunk of one solve compiles and loads every kernel
    pb.batched_solve_chunked(shape, conf, batches[0], max_iters=tr["chunk"],
                             chunk=tr["chunk"], device=ctx.device)
    return dict(conf=conf, shape=shape, batches=batches, draws=draws)


def _launches():
    import importlib
    n = 0
    for mod, attr in COUNTERS:
        n += getattr(importlib.import_module(mod), attr, 0)
    return n


def window(ctx, st):
    from isdf_torch.parallel import batch as pb

    tr = ctx.traffic
    results, solves = [], []
    records = {"solves": solves}
    rec = trace.SweepRecorder() if ctx.trace else None

    def solve(i):
        b = st["batches"][i % len(st["batches"])]
        n0 = _launches()
        t0 = time.perf_counter()
        out = pb.batched_solve_chunked(st["shape"], st["conf"], b,
                                       max_iters=tr["max_iters"],
                                       chunk=tr["chunk"], device=ctx.device)
        ctx.sync()
        solves.append({"s": time.perf_counter() - t0,
                       "launches": _launches() - n0, "B": tr["B"]})
        results.append((i % len(st["batches"]), out))

    t_start = time.perf_counter()
    i = 0
    if ctx.trace:            # the first solve under the profiler
        with rec.active(), trace.profiled(records):
            solve(i)
        i += 1
        records["sweeps"] = rec.calls()
        records["profiled_solves"] = 1
    while time.perf_counter() - t_start < ctx.seconds:
        solve(i)
        i += 1
    t_end = time.perf_counter()
    attempted = tr["B"] * len(results)
    records["config"] = ctx.config
    return {"attempted": attempted, "results": results, "records": records,
            "walls": [s["s"] for s in solves],
            "e2e": {"plans_per_s": attempted / (t_end - t_start)}}


def answers(ctx, st, win):
    """The sampled scenarios' answers and inputs, on the host."""
    rng = np.random.default_rng(ctx.seed)
    res = win["results"]
    B = ctx.traffic["B"]
    n = min(ctx.traffic["check"], B * len(res))
    picks = rng.choice(B * len(res), size=n, replace=False)
    costs = torch.cat([o[2] for _, o in res]).cpu()
    ans = {k: [] for k in ("head", "tail", "c", "T", "f", "pts", "mask",
                           "q0", "T0")}
    for p in sorted(picks):
        j, b = divmod(int(p), B)
        pool_i, (coeffs, T, f, _) = res[j]
        d = st["draws"][pool_i]
        for k, v in (("head", d["head"][b]), ("tail", d["tail"][b]),
                     ("pts", d["points"][b]), ("mask", d["mask"][b]),
                     ("q0", d["q0"][b]), ("T0", d["T0"][b])):
            ans[k].append(np.asarray(v))
        ans["c"].append(coeffs[b].double().cpu().numpy())
        ans["T"].append(T[b].double().cpu().numpy())
        ans["f"].append(float(f[b]))
    ans = {k: np.stack(v) for k, v in ans.items()}
    return {"answers": ans, "nonfinite": int((~torch.isfinite(costs)).sum())}


def readings(ctx, ans, device) -> dict:
    """The sampled answers' numbers: the widest relative cost gap, the
    largest excess (a cost reported above the reference's), the median and
    90th percentile gap, the share that did not descend and the median
    gradient ratio.  The cell's limits file names those compared; the
    widest gap, which a rare missed basin of the sweep sets, is read by
    ``benchmark/control.py``."""
    r = Judge(ctx.config, device).readings(ans)
    rel = r["cost_rel"]
    gap = rel.abs()
    return {"coef_gap": float(r["coef_gap"].max()),
            "cost_gap": float(gap.max()),
            "cost_excess": float(rel.max()),
            "cost_gap_median": float(gap.median()),
            "cost_gap_q90": float(torch.quantile(gap, 0.9)),
            "not_descended": float((~r["descended"]).double().mean()),
            "grad_ratio_q50": float(torch.quantile(r["grad_ratio"], 0.5))}


def check(ctx, a):
    return readings(ctx, a["answers"], ctx.device), a["nonfinite"]


def control(ctx, a):
    """The control's readings: the reference in the program's place, in
    bfloat16, on the same sampled answers."""
    return readings(ctx, control_answers(ctx.config, a["answers"],
                                         ctx.device), ctx.device)
