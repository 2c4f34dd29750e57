"""The benchmark harness on the card (counterpart of the repository's root
``bench.py``, the JAX package's harness, which ``isdf_tpu/cli.py`` runs as
``bench``): prints one JSON line, appended also to
``bench_torch_history.jsonl`` at the repository's root.

    python -m isdf_torch.cli bench                # the CUDA card
    python -m isdf_torch.cli bench --device cpu   # the kernels' plain versions

The sections are bench.py's, in its order, at its sizes (:class:`BenchSizes`),
seeds and numpy draws:

1. a representative trajectory: six MINCO pieces drawn from
   ``default_rng(0)``, CappedCone, float32 (:func:`bench_trajectory`);
2. swept-SDF throughput: ``sweep_sdf_warm`` at P = 32,768 points (K1, one
   lane a point), one warm call, then 3 repeats of 20 calls, each fed the
   last t*.  The headline ``swept_sdf_grad_evals_per_s_per_chip`` counts
   coarse_n + 8·rounds + 2 body-SDF evaluations a query, as bench.py does.
   ``ISDF_PROFILE=<dir>`` writes a ``torch.profiler`` trace of 3 calls
   there (``sweep_trace.json``, chrome format) and, on the card, prints to
   stderr a call's device busy ms, device events and K1 ms from it;
3. the roofline: ``flops_per_query`` is K1's operation count read off the
   CUDA source (``utils/flops.k1_ops_per_query``); ``fp32_tflops`` and
   ``fp32_util`` set the rate against the H100's FP32 peak outside the
   tensor cores (``utils/flops.PEAK_FP32_FLOPS``), where bench.py's
   ``vpu_tflops`` and ``vpu_util`` set it against the TPU's VPU.  bench.py's
   ``flops_per_query`` is a count of a traced jaxpr under another formula,
   so the two records' numbers are not the same quantity.  ``card`` is the
   card's name and power limit as ``nvidia-smi`` gives them;
4. plans/s of ``batched_solve_chunked`` (K2) at B = 128, 512, 2048 and
   4096 (N = 4, 512 points, 24 iterations, chunk 8): one warm call, then 3
   timed calls, the median and the spread; the peak host RSS and the
   largest per-B peak of ``torch.cuda.max_memory_allocated``;
5. ``batched_solve_audited`` at B = 128 (seed 3): one warm call, one timed;
6. the grid sweep (K3): the torus field (ring 0.6, tube 0.25) on 64³ at
   0.04 m, ``sweep_sdf_warm`` at the same 32,768 points, 5 calls;
7. the single-solve latency: one L-BFGS back-end solve (N = 4, 512 points,
   24 iterations) through ``backend.make_cost_fn`` and ``lbfgs.minimize``,
   one warm call, then 7 timed (``p50_plan_latency_ms``) and 10 back to
   back (``plan_latency_pipelined_ms``).  JAX's solve is one jitted device
   loop, so its pipelined number amortizes the host's wait; the port's
   L-BFGS reads f and g on the host at every line-search step, so each
   solve waits for its own evaluations and the pipelined number stays
   close to the blocking one.  bench.py's ``p50_device_ms`` (16 solves in
   one ``lax.scan``) has no device-resident counterpart here: the port
   reports the device's busy time of one solve, the union of the device
   intervals in a ``torch.profiler`` trace, median of 3 solves.  That part
   runs last: a process plans more slowly after profiler traces.

The baseline: bench.py's ``ref_evals_per_s_measured`` (9.96e6 evals/s) and
``ref_desktop_est`` were measured on the TPU rounds' host with
``native/parity/ref_bench.cpp``, which needs the reference checkout; no
machine the port runs on has it, so ``ref_evals_per_s_measured``,
``vs_baseline`` and ``vs_ref_desktop_est`` are null.

On the CPU (``device="cpu"``) the kernels' plain versions run and the
fields that only a card can give (``CARD_ONLY``) are null: a CPU run never
writes a number under a device metric's name.  ``launches`` counts the
kernel launches of each section (none on the CPU), ``finite_scenarios``
the scenarios whose solve ended finite.  No section is skipped: a kernel
that fails to build or launch stops the bench.
"""

from __future__ import annotations

import json
import os
import resource
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from isdf_torch.config import Config
from isdf_torch.core import flatness as fl
from isdf_torch.core import minco, timemap
from isdf_torch.core.poly import PolyTraj
from isdf_torch.device import resolve_device
from isdf_torch.opt import backend, lbfgs
from isdf_torch.parallel import batch as pb
from isdf_torch.shapes import make_shape
from isdf_torch.shapes.gridsdf import grid_shape
from isdf_torch.sweep import fused_zoom, grid_zoom
from isdf_torch.sweep.sweep_sdf import sweep_sdf_warm
from isdf_torch.utils.flops import PEAK_FP32_FLOPS, k1_ops_per_query

HISTORY = Path(__file__).resolve().parents[1] / "bench_torch_history.jsonl"

# bench.py:69-72, but for the sizes (BenchSizes)
CONF = dict(vmax=5.0, omgmax=5.0, thetamax=1.5, safety_hor=0.4, mem_size=8)
SHAPE = "CappedCone"
PIECES = 4             # N of the batched and latency solves (bench.py:155)
AUDIT_SEED = 3         # the audited batch's draw (bench.py:181-182)
GRID_RES = 0.04        # the torus grid's spacing, m (bench.py:198)
DEVICE_SOLVES = 3      # traced latency solves; p50_device_ms is their median
BUSY_TRIES = 3         # traces taken before one without device events fails

# the fields a CPU run leaves null
CARD_ONLY = ("fp32_tflops", "fp32_util", "peak_device_mb", "p50_device_ms",
             "card")


@dataclass(frozen=True)
class BenchSizes:
    """bench.py's sizes (its defaults); the tests pass small ones."""

    coarse_n: int = 64           # Config.sweep_coarse_samples
    rounds: int = 12             # Config.sweep_refine_rounds
    integral_res: int = 32       # Config.integralIntervs
    sweep_points: int = 32768
    sweep_calls: int = 20
    sweep_repeats: int = 3
    batch_sizes: tuple = (128, 512, 2048, 4096)
    solve_points: int = 512
    solve_iters: int = 24
    chunk: int = 8
    batch_repeats: int = 3
    audit_B: int = 128
    audit_coarse_n: int = 512    # batched_solve_audited's default
    grid_n: int = 64
    grid_calls: int = 5
    latency_solves: int = 7
    pipelined_solves: int = 10


def bench_config(sizes: BenchSizes) -> Config:
    return Config(**CONF, sweep_coarse_samples=sizes.coarse_n,
                  sweep_refine_rounds=sizes.rounds,
                  integralIntervs=sizes.integral_res)


def bench_trajectory(rng, device, dtype=torch.float32) -> PolyTraj:
    """bench.py:75-87: six MINCO pieces from rest at the origin to rest at
    (10, 3, 1.5), the waypoints and then the durations drawn from ``rng``."""
    N = 6
    q = (np.linspace(1, 9, N - 1)[:, None] * np.array([1.0, 0.3, 0.15])
         + rng.normal(scale=0.3, size=(N - 1, 3)))
    T = rng.uniform(1.2, 2.2, size=N)
    tail = np.zeros((3, 3))
    tail[:, 0] = [10.0, 3.0, 1.5]

    def on(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return PolyTraj(on(T), minco.solve(on(q), on(T), on(np.zeros((3, 3))),
                                       on(tail)))


def torus_field(n: int, res: float):
    """bench.py:195-205: the torus (ring 0.6, tube 0.25) sampled on an n³
    grid of spacing res centred on the origin → (field, origin)."""
    origin = np.full(3, -0.5 * n * res)
    ii = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing="ij"), axis=-1)
    p = origin + ii * res
    xy = np.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2) - 0.6
    return np.sqrt(xy ** 2 + p[..., 2] ** 2) - 0.25, origin


def latency_solve(shape, conf, sizes: BenchSizes, device,
                  dtype=torch.float32):
    """bench.py:229-249: the single-plan back end on scenario 0 of
    ``make_random_batch(B=1)`` → (solve, cost_and_grad, x0, t_warm0):
    ``solve()`` runs one L-BFGS solve from x0 and returns its result."""
    sb = pb.make_random_batch(conf, 1, N=PIECES,
                              n_points=sizes.solve_points, device=device,
                              dtype=dtype)
    cost_and_grad = backend.make_cost_fn(
        shape, fl.FlatParams.from_config(conf),
        backend.BackendWeights.from_config(conf), sb.head[0], sb.tail[0],
        PIECES, sb.points[0], sb.mask[0],
        integral_res=conf.integralIntervs,
        coarse_n=conf.sweep_coarse_samples,
        refine_rounds=conf.sweep_refine_rounds)
    x0 = backend.pack(timemap.T_to_tau(sb.T0[0]), sb.q0[0])
    tw0 = torch.zeros(sizes.solve_points, dtype=dtype, device=sb.device)

    def solve():
        return lbfgs.minimize(
            cost_and_grad, x0, tw0, m=conf.mem_size,
            max_iters=sizes.solve_iters, g_epsilon=1e-7, past=conf.past,
            rel_cost_tol=conf.relCostTol)

    return solve, cost_and_grad, x0, tw0


def busy_ns(spans) -> int:
    """Length of the union of (start, end) intervals."""
    busy, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches() -> dict:
    return {"K1": fused_zoom.LAUNCHES, "K2": fused_zoom.LAUNCHES_BATCHED,
            "K3": grid_zoom.LAUNCHES_GRID}


def _since(before: dict) -> dict:
    """The kernels launched since ``before`` → {kernel: launches}."""
    return {k: v - before[k] for k, v in _launches().items()
            if v != before[k]}


def _device_events(prof) -> list:
    """The card's events (kernels, copies, sets) of a torch.profiler trace."""
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def _device_busy_ms(fn, dev) -> float:
    """Milliseconds the card was busy during fn(): the union of the device
    intervals of a torch.profiler trace.  A trace now and then comes back
    without the card's events, so up to ``BUSY_TRIES`` are taken."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(BUSY_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            _sync(dev)
        spans = [(e.start_ns(), e.end_ns()) for e in _device_events(prof)]
        if spans:
            return busy_ns(spans) * 1e-6
    raise RuntimeError(f"torch.profiler recorded no device event in "
                       f"{BUSY_TRIES} traces")


def _card(dev):
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index or 0}"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def _finite(*ts) -> torch.Tensor:
    """Per scenario: every entry of every (B, ...) tensor finite → (B,)."""
    return torch.stack([torch.isfinite(t).reshape(t.shape[0], -1).all(1)
                        for t in ts]).all(0)


def run(device=None, sizes: BenchSizes = BenchSizes(),
        history=HISTORY) -> dict:
    """Every section of the bench on ``device`` (default: the CUDA card;
    raises without one) → the record, also appended to ``history`` as one
    JSON line."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    dtype = torch.float32
    profile_dir = os.environ.get("ISDF_PROFILE", "")
    conf = bench_config(sizes)
    shape = make_shape(SHAPE, conf)
    params = fl.FlatParams.from_config(conf)
    coarse_n, rounds = conf.sweep_coarse_samples, conf.sweep_refine_rounds
    launches = {}

    # 1) the representative trajectory
    rng = np.random.default_rng(0)
    traj = bench_trajectory(rng, dev, dtype)

    # 2) swept-SDF point-query throughput (K1)
    P = sizes.sweep_points
    pts = torch.as_tensor(rng.uniform(-1, 11, size=(P, 3)), dtype=dtype,
                          device=dev)
    t_warm = torch.zeros(P, dtype=dtype, device=dev)

    def sweep(s, tw):
        return sweep_sdf_warm(s, traj, params, pts, tw, coarse_n=coarse_n,
                              refine_rounds=rounds, device=dev)

    before = _launches()
    _, t_star, _ = sweep(shape, t_warm)
    _sync(dev)
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            for _ in range(3):
                _, t_star, _ = sweep(shape, t_star)
            _sync(dev)
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir,
                                              "sweep_trace.json"))
        if on_card:
            ev = _device_events(prof)
            k1 = [e for e in ev if "sweep_warm_kernel" in e.name()]
            print("bench: ISDF_PROFILE, a sweep call on the card "
                  + json.dumps(dict(
                      busy_ms=busy_ns([(e.start_ns(), e.end_ns())
                                       for e in ev]) * 1e-6 / 3,
                      device_events=len(ev) / 3,
                      k1_ms=sum(e.end_ns() - e.start_ns()
                                for e in k1) * 1e-6 / 3)),
                  file=sys.stderr, flush=True)
    sweep_dts = []
    for _ in range(sizes.sweep_repeats):
        t0 = time.perf_counter()
        for _ in range(sizes.sweep_calls):
            _, t_star, _ = sweep(shape, t_star)
        _sync(dev)
        sweep_dts.append((time.perf_counter() - t0) / sizes.sweep_calls)
    launches["sweep"] = _since(before)
    queries_per_s = P / float(np.median(sweep_dts))
    evals_per_query = coarse_n + 8 * rounds + 2
    sdf_evals_per_s = queries_per_s * evals_per_query

    # 3) the roofline: K1's operations a query against the FP32 peak
    flops_query = k1_ops_per_query(shape, coarse_n, rounds)
    fp32_flops = queries_per_s * flops_query

    # 4) batched plans/s scaling (K2)
    n_pts, iters, chunk = sizes.solve_points, sizes.solve_iters, sizes.chunk
    scaling, scaling_spread, finite = {}, {}, {}
    launches["plans_scaling"] = {}
    peak_dev = 0
    for B in sizes.batch_sizes:
        sb = pb.make_random_batch(conf, B, N=PIECES, n_points=n_pts,
                                  device=dev, dtype=dtype)
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        before = _launches()
        out = pb.batched_solve_chunked(shape, conf, sb, max_iters=iters,
                                       chunk=chunk, device=dev)
        _sync(dev)
        dts = []
        for _ in range(sizes.batch_repeats):
            t0 = time.perf_counter()
            out = pb.batched_solve_chunked(shape, conf, sb, max_iters=iters,
                                           chunk=chunk, device=dev)
            _sync(dev)
            dts.append(time.perf_counter() - t0)
        launches["plans_scaling"][str(B)] = _since(before)
        if on_card:
            peak_dev = max(peak_dev, torch.cuda.max_memory_allocated(dev))
        coeffs, T, costs, _ = out
        finite[str(B)] = int(_finite(coeffs, T, costs).sum())
        scaling[str(B)] = B / float(np.median(dts))
        scaling_spread[str(B)] = [B / max(dts), B / min(dts)]
    peak_host_rss_mb = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1024

    # 5) audited batched throughput: solve + audit + warm re-solves
    sba = pb.make_random_batch(conf, sizes.audit_B, N=PIECES,
                               n_points=n_pts, seed=AUDIT_SEED,
                               device=dev, dtype=dtype)
    before = _launches()
    audit_kw = dict(max_iters=iters, chunk=chunk,
                    audit_coarse_n=sizes.audit_coarse_n, device=dev)
    pb.batched_solve_audited(shape, conf, sba, **audit_kw)
    _sync(dev)
    t0 = time.perf_counter()
    coeffs, T, costs, _, audit = pb.batched_solve_audited(
        shape, conf, sba, **audit_kw)
    _sync(dev)
    plans_audited_per_s = sizes.audit_B / (time.perf_counter() - t0)
    launches["audited"] = _since(before)
    finite["audited"] = int((_finite(coeffs, T, costs) & torch.as_tensor(
        np.isfinite(audit["min_sdf"]), device=dev)).sum())

    # 6) grid-shape (mesh robot) sweep throughput (K3)
    field, origin = torus_field(sizes.grid_n, GRID_RES)
    gshape = grid_shape(f"bench_torus{sizes.grid_n}", field, origin,
                        GRID_RES, device=dev)
    before = _launches()
    _, t_g, _ = sweep(gshape, t_warm)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(sizes.grid_calls):
        _, t_g, _ = sweep(gshape, t_g)
    _sync(dev)
    grid_queries_per_s = P * sizes.grid_calls / (time.perf_counter() - t0)
    launches["grid"] = _since(before)

    # 7) the single-solve latency (K1 at P = 512); the profiled solves last
    solve1, _, _, _ = latency_solve(shape, conf, sizes, dev, dtype)
    before = _launches()
    solve1()
    _sync(dev)
    lats = []
    for _ in range(sizes.latency_solves):
        t0 = time.perf_counter()
        solve1()
        _sync(dev)
        lats.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(sizes.pipelined_solves):
        solve1()
    _sync(dev)
    pipelined_ms = (time.perf_counter() - t0) / sizes.pipelined_solves * 1e3
    p50_device_ms = float(np.median([
        _device_busy_ms(solve1, dev) for _ in range(DEVICE_SOLVES)
    ])) if on_card else None
    launches["latency"] = _since(before)

    record = {
        "metric": "swept_sdf_grad_evals_per_s_per_chip",
        "value": sdf_evals_per_s,
        "unit": "evals/s",
        "vs_baseline": None,
        "vs_ref_desktop_est": None,
        "ref_evals_per_s_measured": None,
        "sweep_point_queries_per_s": queries_per_s,
        "flops_per_query": flops_query,
        "fp32_tflops": fp32_flops / 1e12 if on_card else None,
        "fp32_util": fp32_flops / PEAK_FP32_FLOPS if on_card else None,
        "sweep_mqps_spread": [P / max(sweep_dts) / 1e6,
                              P / min(sweep_dts) / 1e6],
        "plans_per_s_per_chip": scaling[str(sizes.batch_sizes[0])],
        "plans_per_s_audited": plans_audited_per_s,
        "grid_queries_per_s": grid_queries_per_s,
        "plans_scaling": scaling,
        "plans_scaling_spread": scaling_spread,
        "peak_host_rss_mb": peak_host_rss_mb,
        "peak_device_mb": peak_dev / 1e6 if on_card else None,
        "p50_plan_latency_ms": float(np.median(lats)) * 1e3,
        "plan_latency_pipelined_ms": pipelined_ms,
        "p50_device_ms": p50_device_ms,
        "plan_iters": iters,
        "device": torch.cuda.get_device_name(dev) if on_card else str(dev),
        "card": _card(dev) if on_card else None,
        "launches": launches,
        "finite_scenarios": finite,
        "ts": time.time(),
    }
    with open(history, "a") as f:
        f.write(json.dumps(record) + "\n")
    return record


def main(device=None) -> None:
    """Run the bench and print its record as one JSON line."""
    print(json.dumps(run(device)), flush=True)


if __name__ == "__main__":
    main()
