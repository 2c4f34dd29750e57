"""The span recorder of ``isdf_torch.utils.obs`` on the port's two hot paths,
float64 on the CPU: a plan's span tree, the evaluation and trip counts the
spans give against the solvers' own, nothing recorded while off, and the
spans read with a finished profiler on its events' times.  On the card: one
lockstep chunk makes no synchronising call, so the ``host_read`` spans
between chunks are every read of a solve."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from isdf_torch.config import Config
from isdf_torch.parallel import batch as pb
from isdf_torch.plan import PlannerManager
from isdf_torch.shapes import grid_shape, make_shape
from isdf_torch.utils import obs
from isdf_torch.world import GridMap, maps_gen

F64 = torch.float64

PLAN_CONF = dict(
    mapBound=(0.0, 12.0, 0.0, 12.0, 0.0, 6.0), occupancy_resolution=0.5,
    kernel_size=5, kernel_max_roll=0.0, kernel_max_pitch=0.0,
    kernel_ang_res=9.0, integralIntervs=8, sweep_coarse_samples=32,
    sweep_refine_rounds=8, max_obstacle_points=256, inittime=2.0, vmax=5.0,
    omgmax=5.0, thetamax=1.5, safety_hor=0.3, traj_parlength=2.0)
START, GOAL = np.array([1.0, 5.0, 3.0]), np.array([10.5, 5.0, 3.0])

BATCH_CONF = dict(integralIntervs=8, sweep_coarse_samples=64,
                  sweep_refine_rounds=4, vmax=5.0, omgmax=5.0, thetamax=1.5,
                  safety_hor=0.4, mem_size=8)
CHUNK = 3

PHASES = {"plan.front_end", "plan.gather", "plan.mid_end", "plan.back_end",
          "plan.audit"}
EVAL_PARTS = {"eval.sweep"}


@pytest.fixture(scope="module")
def manager():
    pm = PlannerManager(Config(**PLAN_CONF), shape_name="Ball", device="cpu",
                        dtype=F64)
    pts = np.concatenate([
        maps_gen.gene_wall(5.0, 0.0, 1.0, 4.0, 6.0, res=0.25),
        maps_gen.gene_wall(5.0, 7.0, 1.0, 5.0, 6.0, res=0.25)])
    pm.set_map(GridMap.from_points(pts, PLAN_CONF["mapBound"], 0.5, 1,
                                   device="cpu"))
    return pm


def _plan(pm):
    return pm.plan(START, GOAL, max_iters=6)


def _solve(max_iters=3 * CHUNK):
    conf = Config(**BATCH_CONF)
    batch = pb.make_random_batch(conf, 2, N=3, n_points=12, seed=1,
                                 device="cpu", dtype=F64)
    return pb.batched_solve_chunked(make_shape("Ball", conf), conf, batch,
                                    max_iters=max_iters, chunk=CHUNK,
                                    device="cpu")


def _traced(fn, *args):
    obs.clear()
    with obs.tracing():
        out = fn(*args)
    return out, obs.spans()


def _by(spans, name):
    return [s for s in spans if s.name == name]


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


@pytest.fixture(scope="module")
def traced_plan(manager):
    return _traced(_plan, manager)


def test_plan_span_tree(traced_plan):
    res, spans = traced_plan
    assert res.success
    (root,) = _by(spans, "plan")
    assert root.parent == 0 and root.request == root.id
    assert {s.request for s in spans} == {root.id}
    ids = {s.id: s for s in spans}
    phases = _children(spans, root)
    assert {s.name for s in phases} <= PHASES
    assert {"plan.front_end", "plan.gather", "plan.mid_end",
            "plan.back_end", "plan.audit"} <= {s.name for s in phases}
    back = _by(spans, "plan.back_end")
    assert [s.attrs["solve"] for s in back] == list(range(len(back)))
    assert len(back) == 1 + res.metrics.get("safety_replans", 0)
    for s in _by(spans, "back_end.eval"):
        assert ids[s.parent].name == "plan.back_end"
        assert {c.name for c in _children(spans, s)} == EVAL_PARTS
    for s in _by(spans, "mid_end.eval"):
        assert ids[s.parent].name == "plan.mid_end"
    for s in _by(spans, "host_read"):
        assert ids[s.parent].name in ("plan.mid_end", "plan.back_end")
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent:
            up = ids[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns


def test_plan_eval_spans_count_the_solvers_evaluations(traced_plan):
    res, spans = traced_plan
    m = res.metrics
    assert len(_by(spans, "back_end.eval")) == m["back_end_evals"]
    assert len(_by(spans, "mid_end.eval")) == m["mid_end_evals"]
    (mid,) = _by(spans, "plan.mid_end")
    assert mid.attrs["iterations"] == m["mid_end_iters"]
    assert sum(s.attrs["iterations"] for s in _by(spans, "plan.back_end")) \
        == m["back_end_iters"]


def test_evaluations_are_one_plus_iterations_plus_trials(traced_plan):
    _, spans = traced_plan
    for s in _by(spans, "plan.back_end") + _by(spans, "plan.mid_end"):
        a = s.attrs
        assert a["trials"] >= a["iterations"] > 0
        assert a["evaluations"] == 1 + a["iterations"] + a["trials"]
        evals = [c for c in _children(spans, s)
                 if c.name in ("back_end.eval", "mid_end.eval")]
        assert len(evals) == a["evaluations"]


def test_lockstep_trips_and_evaluations():
    _, spans = _traced(_solve)
    (solve,) = _by(spans, "batch.solve")
    a = solve.attrs
    assert {s.request for s in spans} == {solve.id}
    trips = _by(spans, "lockstep.trip")
    assert a["trips"] == len(trips) == (2 * CHUNK + 8) * a["chunks"]
    assert all(t.parent == solve.id for t in trips)
    evals = _by(spans, "back_end.eval")
    assert len(evals) == 1 + 2 * a["trips"]
    # every evaluation but the first runs inside a trip
    assert sum(e.parent == solve.id for e in evals) == 1
    reads = _by(spans, "host_read")
    assert len(reads) == a["host_reads"] >= a["chunks"] - 1
    assert all(r.parent == solve.id for r in reads)
    assert a["chunks"] == 3 or a["host_reads"] == a["chunks"]


def test_nothing_recorded_while_off(manager):
    assert not obs.recording()
    obs.clear()
    assert _plan(manager).success
    _solve(max_iters=CHUNK)
    assert obs.spans() == []


def test_spans_share_the_profilers_clock(manager):
    """Each span is a record_function event of its name in the trace, over
    the same interval to within 50 µs, once the spans are read with the
    finished profiler."""
    obs.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert obs.recording()
        _plan(manager)
        _solve(max_iters=CHUNK)
    assert not obs.recording()
    spans = obs.spans(prof)
    names = {s.name for s in spans}
    assert {"plan", "batch.solve", "lockstep.trip", "host_read"} <= names
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    for name in names:
        mine = sorted((s.start_ns, s.end_ns) for s in _by(spans, name))
        theirs = sorted(events.get(name, []))
        assert len(mine) == len(theirs), name
        gap = np.abs(np.asarray(mine, np.int64)
                     - np.asarray(theirs, np.int64)).max()
        assert gap <= 50_000, (name, gap)


def _ball_field(n=24, res=0.1, r=0.6):
    ax = (np.arange(n) - (n - 1) / 2) * res
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.sqrt(x * x + y * y + z * z) - r, -(n - 1) / 2 * res * np.ones(3)


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["Ball", "grid"])
def test_lockstep_chunk_makes_no_synchronising_call(body):
    """A resumed chunk of the batched solve under the sync debug mode
    "error": any call that makes the host wait for the card raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the sync debug mode is CUDA's)")
    dev = torch.device("cuda")
    conf = Config(**BATCH_CONF)
    if body == "Ball":
        shape = make_shape("Ball", conf)
    else:
        field, origin = _ball_field()
        shape = grid_shape("ball_grid", field, origin, 0.1, device=dev)
    batch = pb.make_random_batch(conf, 64, N=4, n_points=64, seed=2,
                                 device=dev)
    cost_and_grad = pb._cost_fn(shape, conf, batch)
    kw = dict(trace_len=2 * CHUNK + 8)
    res = pb._lockstep(conf, cost_and_grad, pb._x0(batch),
                       torch.zeros_like(batch.points[..., 0]), CHUNK, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = pb._lockstep(conf, cost_and_grad, res.x, res.aux, CHUNK,
                           resume_state=res.state, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert res.n_loops == 2 * CHUNK + 8
    assert bool(torch.isfinite(res.f).all())
