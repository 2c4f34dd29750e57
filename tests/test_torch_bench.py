"""The port's benchmark harness (isdf_torch/bench.py, the cli's ``bench``) on
the CPU at small sizes: its trajectory and its latency solve against the JAX
package's, float64, and the record it prints, with bench.py's keys.

JAX on the CPU sweeps through its non-fused path, so the latency solve is
held against JAX's through the port's non-fused path (CappedCone with
``spec=None``), as tests/test_torch_multidevice.py holds the batched solve.
JAX's compile of that solve takes 80-110 s on the CPU (30 s with its
persistent cache warm), so the comparison is marked slow; the solve's inputs
and one evaluation of its cost (JAX's un-jitted) are held against JAX's in
Tier-1, and the port's solve runs there."""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.config import Config as JConfig
from isdf_tpu.core import flatness as jfl
from isdf_tpu.core import minco as jminco
from isdf_tpu.core import timemap as jtimemap
from isdf_tpu.opt import backend as jbackend
from isdf_tpu.opt import lbfgs as jlbfgs
from isdf_tpu.parallel import batch as jpb
from isdf_tpu.shapes import make_shape as jmake_shape

from isdf_torch import bench, cli
from isdf_torch.shapes import make_shape

F64 = torch.float64
# bench.py:292-316, with the roofline's vpu_* renamed fp32_*
JAX_KEYS = (
    "metric", "value", "unit", "vs_baseline", "vs_ref_desktop_est",
    "ref_evals_per_s_measured", "sweep_point_queries_per_s",
    "flops_per_query", "fp32_tflops", "fp32_util", "sweep_mqps_spread",
    "plans_per_s_per_chip", "plans_per_s_audited", "grid_queries_per_s",
    "plans_scaling", "plans_scaling_spread", "peak_host_rss_mb",
    "peak_device_mb", "p50_plan_latency_ms", "plan_latency_pipelined_ms",
    "p50_device_ms", "plan_iters", "device")
BASELINE = ("vs_baseline", "vs_ref_desktop_est", "ref_evals_per_s_measured")
SMALL = bench.BenchSizes(
    sweep_points=64, sweep_calls=2, sweep_repeats=1, batch_sizes=(2, 4),
    solve_points=64, solve_iters=1, chunk=1, batch_repeats=1, audit_B=1,
    coarse_n=16, rounds=3, integral_res=8, audit_coarse_n=32, grid_n=16,
    grid_calls=2, latency_solves=2, pipelined_solves=2)
# the latency solve held against JAX's: N = 4, P = 32, 3 iterations, at the
# bench's coarse_n, rounds and integral resolution
LATENCY = bench.BenchSizes(solve_points=32, solve_iters=3)
# f and x of the two solves (measured: 2e-13 and 3e-13)
SOLVE_RTOL = 1e-8
# f, g (also against its largest entry) and t* of one evaluation (measured:
# 2e-16, 1.8e-14 of the largest entry, 3.6e-15 s)
EVAL_RTOL = 1e-10


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these runs are thousands of small operations,
    no slower on one (measured), and the suite runs beside them in other
    processes, where a thread pool a process contends for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_trajectory_matches_jax():
    """Section 1: the same draws (bench.py:77-87, restated here) through
    JAX's minco.solve and the port's bench_trajectory, float64, and the rng
    left where bench.py leaves it for the points."""
    rng = np.random.default_rng(0)
    N = 6
    q = (np.linspace(1, 9, N - 1)[:, None] * np.array([1.0, 0.3, 0.15])
         + rng.normal(scale=0.3, size=(N - 1, 3)))
    T = rng.uniform(1.2, 2.2, size=N)
    tail = np.zeros((3, 3))
    tail[:, 0] = [10.0, 3.0, 1.5]
    coeffs = np.asarray(jminco.solve(jnp.asarray(q), jnp.asarray(T),
                                     jnp.zeros((3, 3)), jnp.asarray(tail)))

    rng_t = np.random.default_rng(0)
    traj = bench.bench_trajectory(rng_t, "cpu", F64)
    np.testing.assert_allclose(traj.durations.numpy(), T, rtol=0, atol=1e-12)
    np.testing.assert_allclose(traj.coeffs.numpy(), coeffs, rtol=1e-12,
                               atol=1e-12)
    assert rng_t.bit_generator.state == rng.bit_generator.state


def _jax_latency(sizes):
    """bench.py:229-249 in JAX at ``sizes``, float64 → (cost_and_grad, x0,
    t_warm0, config)."""
    jc = JConfig(**bench.CONF, sweep_coarse_samples=sizes.coarse_n,
                 sweep_refine_rounds=sizes.rounds,
                 integralIntervs=sizes.integral_res)
    sb = jpb.make_random_batch(jc, B=1, N=bench.PIECES,
                               n_points=sizes.solve_points,
                               dtype=jnp.float64)
    cg = jbackend.make_cost_fn(
        jmake_shape(bench.SHAPE, jc), jfl.FlatParams.from_config(jc),
        jbackend.BackendWeights.from_config(jc), sb.head[0], sb.tail[0],
        bench.PIECES, sb.points[0], sb.mask[0],
        integral_res=jc.integralIntervs, coarse_n=jc.sweep_coarse_samples,
        refine_rounds=jc.sweep_refine_rounds)
    x0 = jbackend.pack(jtimemap.T_to_tau(sb.T0[0]), sb.q0[0])
    return cg, x0, jnp.zeros(sizes.solve_points), jc


def _port_latency(sizes):
    """The port's latency solve at ``sizes`` through its non-fused sweep
    (JAX's path on the CPU), float64."""
    conf = bench.bench_config(sizes)
    shape = dataclasses.replace(make_shape(bench.SHAPE, conf), spec=None)
    return bench.latency_solve(shape, conf, sizes, "cpu", F64)


def test_latency_inputs_match_jax_and_the_solve_descends():
    """Section 7's start (the batch's draws, x0 = pack(T_to_tau(T0), q0))
    equal to JAX's; the port's solve runs its iterations and descends."""
    _, jx0, _, _ = _jax_latency(LATENCY)
    solve, cost_and_grad, x0, tw0 = _port_latency(LATENCY)
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), rtol=1e-12,
                               atol=1e-12)
    f0 = float(cost_and_grad(x0, tw0)[0])
    res = solve()
    assert res.n_iters == LATENCY.solve_iters
    assert math.isfinite(float(res.f)) and float(res.f) < f0


def test_latency_cost_and_grad_matches_jax():
    """Section 7's cost as the bench composes it (make_cost_fn at the
    bench's config and x0): one evaluation at (x0, zeros) against JAX's
    un-jitted make_cost_fn on the same inputs, float64: f, g and t* within
    EVAL_RTOL.  JAX's first evaluation compiles for 30-40 s on the CPU at
    any size (measured; jitted or not), the most of this file's time."""
    cg, jx0, jtw0, _ = _jax_latency(LATENCY)
    _, cost_and_grad, x0, tw0 = _port_latency(LATENCY)
    jf, jg, jt = cg(jx0, jtw0)
    f, g, t = cost_and_grad(x0, tw0)
    np.testing.assert_allclose(float(f), float(jf), rtol=EVAL_RTOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=EVAL_RTOL,
                               atol=EVAL_RTOL * float(np.abs(jg).max()))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0,
                               atol=EVAL_RTOL)


@pytest.mark.slow
def test_latency_solve_matches_jax():
    """Section 7's solve (N = 4, P = 32, 3 iterations) against JAX's
    lbfgs.minimize on the same cost, jitted as bench.py jits it: the same
    iterations and evaluations, f and x within SOLVE_RTOL."""
    cg, jx0, jtw0, jc = _jax_latency(LATENCY)
    rj = jax.jit(lambda x, tw: jlbfgs.minimize(
        cg, x, tw, m=jc.mem_size, max_iters=LATENCY.solve_iters,
        g_epsilon=1e-7, past=jc.past, rel_cost_tol=jc.relCostTol))(jx0, jtw0)
    rt = _port_latency(LATENCY)[0]()
    assert rt.n_iters == int(rj.n_iters) == LATENCY.solve_iters
    assert rt.n_evals == int(rj.n_evals)
    np.testing.assert_allclose(float(rt.f), float(rj.f), rtol=SOLVE_RTOL)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x),
                               rtol=SOLVE_RTOL, atol=0)


def _numbers(v):
    if isinstance(v, dict):
        for x in v.values():
            yield from _numbers(x)
    elif isinstance(v, list):
        for x in v:
            yield from _numbers(x)
    else:
        yield v


def test_run_on_the_cpu(tmp_path, monkeypatch):
    """Every section at small sizes: bench.py's keys, the baseline and the
    card's fields null on the CPU, every other number finite and positive,
    no kernel launched (plain versions), every scenario finite, the record
    appended to the history as the line main prints, and ISDF_PROFILE's
    trace written."""
    monkeypatch.setenv("ISDF_PROFILE", str(tmp_path / "prof"))
    hist = tmp_path / "history.jsonl"
    rec = bench.run(device="cpu", sizes=SMALL, history=hist)

    assert set(JAX_KEYS) <= set(rec)
    for k in BASELINE + bench.CARD_ONLY:
        assert rec[k] is None, k
    assert rec["device"] == "cpu" and rec["plan_iters"] == SMALL.solve_iters
    assert rec["metric"] == "swept_sdf_grad_evals_per_s_per_chip"
    assert set(rec["plans_scaling"]) == set(rec["plans_scaling_spread"]) \
        == {"2", "4"}
    assert rec["plans_per_s_per_chip"] == rec["plans_scaling"]["2"]
    assert rec["finite_scenarios"] == {"2": 2, "4": 4, "audited": 1}
    assert rec["launches"] == {"sweep": {}, "plans_scaling": {"2": {},
                                                              "4": {}},
                               "audited": {}, "grid": {}, "latency": {}}
    evals = SMALL.coarse_n + 8 * SMALL.rounds + 2
    assert rec["value"] == pytest.approx(
        rec["sweep_point_queries_per_s"] * evals)
    skip = set(BASELINE + bench.CARD_ONLY) | {
        "metric", "unit", "device", "launches", "finite_scenarios"}
    for k, v in rec.items():
        if k in skip:
            continue
        for x in _numbers(v):
            assert isinstance(x, (int, float)) and math.isfinite(x) \
                and x > 0, (k, v)
    assert hist.read_text() == json.dumps(rec) + "\n"
    assert (tmp_path / "prof" / "sweep_trace.json").stat().st_size > 0


def test_busy_ns_is_the_union_of_intervals():
    assert bench.busy_ns([]) == 0
    assert bench.busy_ns([(5, 9), (0, 2), (1, 3), (8, 12), (20, 21)]) == 11


def test_cli_bench_passes_the_device_and_prints_the_record(monkeypatch,
                                                           capsys):
    seen = []

    def fake_run(device=None):
        seen.append(device)
        return {"metric": "swept_sdf_grad_evals_per_s_per_chip",
                "device": device}

    monkeypatch.setattr(bench, "run", fake_run)
    cli.main(["bench", "--device", "cpu"])
    assert seen == ["cpu"]
    assert capsys.readouterr().out.splitlines()[-1] == json.dumps(
        {"metric": "swept_sdf_grad_evals_per_s_per_chip", "device": "cpu"})
