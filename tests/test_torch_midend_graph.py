"""The mid end's evaluation as a function of tensors only
(``midend.MidCost``) and the CUDA graph that replays it (``midend._Graph``,
kept in ``midend.GRAPHS``; its lifecycle is ``tests/test_torch_graphs.py``'s).

On the CPU: the tensor-only evaluation gives the eager evaluation's f and g
bit for bit, with and without the attitude term, under ``FlatParams`` and
``PlanarPose``; every CPU evaluation runs eagerly, marked so on its
``mid_end.eval`` span and in ``GRAPHS.evals``, and makes no capture; the
keys.  On the card (``cuda``): replays against eager warm-ups, a whole
solve with graphs against one without, a cached key taking a new
problem."""

import numpy as np
import pytest
import torch

from isdf_torch.config import Config
from isdf_torch.core import flatness as fl
from isdf_torch.core import minco, timemap
from isdf_torch.core.poly import beta
from isdf_torch.opt import backend, graphs, midend
from isdf_torch.opt.attitude import attitude_penalty, pad_attitude_refs
from isdf_torch.opt.graphs import GraphCache
from isdf_torch.utils import obs

F64 = torch.float64
CONF = dict(integralIntervs=8, weight_ar=2000.0, rho_mid_end=200.0,
            weight_pr=1000.0, mem_size=8)


def _rot(r, p):
    cr, sr, cp, sp = np.cos(r), np.sin(r), np.cos(p), np.sin(p)
    return np.array([[cp, 0.0, sp],
                     [sr * sp, cr, -sr * cp],
                     [-cr * sp, sr, cr * cp]])


def _problem(N=4, seed=0, device="cpu", dtype=F64):
    """(head, tail, waypoints (N−1, 3), T0 (N,), rot_refs (N−1, 3, 3)) of
    a random problem along the x axis."""
    rng = np.random.default_rng(seed)
    wps = (np.linspace(2.0, 10.0, N - 1)[:, None] * np.array([1.0, 0.4, 0.1])
           + rng.normal(scale=0.3, size=(N - 1, 3)))
    head, tail = np.zeros((3, 3)), np.zeros((3, 3))
    head[:, 0] = rng.normal(scale=0.2, size=3) + [0.0, 0.0, 1.0]
    tail[:, 0] = rng.normal(scale=0.2, size=3) + [12.0, 5.0, 1.5]
    T0 = np.full(N, 2.0) * rng.uniform(0.8, 1.2, N)
    rots = np.stack([_rot(*rng.uniform(-0.5, 0.5, 2)) for _ in range(N - 1)])
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (head, tail, wps, T0, rots))


def _cost_fn(N=4, seed=0, att=True, params=None, device="cpu", dtype=F64,
             conf=None):
    """(make_cost_fn's (cost_and_grad, raw_cost), x, its tensors)."""
    conf = Config(**(conf or CONF))
    head, tail, wps, T0, rots = _problem(N, seed, device, dtype)
    refs = pad_attitude_refs(rots, dtype, torch.device(device)) \
        if att else None
    if params is None:
        params = fl.FlatParams.from_config(conf)
    fns = midend.make_cost_fn(
        head, tail, N, wps, conf.rho_mid_end, conf.weight_pr,
        conf.integralIntervs, att=refs, weight_ar=conf.weight_ar,
        smooth_fac=conf.smoothingEps, params=params,
        bridge=conf.attitude_bridge)
    x = backend.pack(timemap.T_to_tau(T0), wps)
    return fns, x, (head, tail, wps, refs)


def _closure_eval(x, head, tail, ref_points, att, conf, params, N):
    """The mid end's evaluation as a closure over the problem's tensors, as
    the eager path computed it before the tensor-only form."""
    xg = x.detach().requires_grad_(True)
    with torch.enable_grad():
        traj, T, _ = backend.build_traj(xg, N, head, tail)
        e = minco.energy(traj.coeffs, T)
        t_cost = conf.rho_mid_end * torch.sum(T)
        s = (1.0 / conf.integralIntervs) * T[1:]
        pos = torch.einsum("nk,nkd->nd", beta(s, 0), traj.coeffs[1:])
        diff = pos - ref_points
        dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
        f = e + t_cost + conf.weight_pr * torch.sum(dist ** 3)
        if att is not None:
            f = f + attitude_penalty(traj, params, att, conf.weight_ar,
                                     conf.smoothingEps, conf.integralIntervs,
                                     bridge=conf.attitude_bridge)
        (g,) = torch.autograd.grad(f, xg)
    return f.detach(), g


POSES = {"flat": lambda: fl.FlatParams.from_config(Config(**CONF)),
         "planar": lambda: fl.PlanarPose(z_ref=1.0)}


def _mid_cost(N, params=None, conf=None, **change):
    """The MidCost that make_cost_fn binds for ``conf``."""
    conf = Config(**dict(conf or CONF, **change))
    return midend.MidCost(
        N, conf.rho_mid_end, conf.weight_pr, conf.integralIntervs,
        conf.weight_ar, conf.smoothingEps,
        POSES["flat"]() if params is None else params, conf.attitude_bridge)


@pytest.mark.parametrize("att", [True, False], ids=["attitude", "no_att"])
@pytest.mark.parametrize("pose", list(POSES))
def test_tensor_only_evaluation_equals_the_eager_one(pose, att):
    """MidCost on copies of the problem's tensors (as a graph's static
    inputs hold them), make_cost_fn's eager evaluation and the closure form
    give the same f and g, bit for bit; so does the flat output's split."""
    params = POSES[pose]()
    (cg, raw), x, tensors = _cost_fn(N=5, att=att, params=params)
    cost = _mid_cost(5, params)
    copies = [None if t is None else t.clone() for t in tensors]
    f, g = cost.value_and_grad(x.clone(), *copies)
    fe, ge, aux = cg(x, "aux")
    fc, gc = _closure_eval(x, *tensors, Config(**CONF), params, 5)
    assert aux == "aux"
    for a, b in ((f, fe), (g, ge), (f, fc), (g, gc)):
        assert a.shape == b.shape and torch.equal(a, b)
    assert torch.equal(raw(x), fc)
    out = midend._flat(f, g).clone()
    assert torch.equal(out[0], f) and torch.equal(out[1:], g)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0.0
    if att:
        # the attitude term is on: its weight moves the cost
        off = _mid_cost(5, params, weight_ar=0.0)
        assert not torch.equal(off.value_and_grad(x, *copies)[0], f)


def _count(fn):
    before = dict(midend.GRAPHS.evals)
    keys = len(midend.GRAPHS.entries)
    obs.clear()
    with obs.tracing():
        out = fn()
    evals = [s for s in obs.spans() if s.name == "mid_end.eval"]
    moved = {k: midend.GRAPHS.evals[k] - before[k] for k in before}
    return out, evals, moved, len(midend.GRAPHS.entries) - keys


@pytest.mark.parametrize("how", ["evaluations", "solve"])
def test_cpu_evaluations_run_eagerly(how):
    """Every CPU evaluation is eager: its ``mid_end.eval`` span says
    ``graph = eager``, the eager counter rises by one an evaluation, and no
    key is made."""
    if how == "evaluations":
        (cg, _), x, _ = _cost_fn()
        _, evals, moved, keys = _count(
            lambda: [cg(x + 0.01 * i, None) for i in range(graphs.WARMUP
                                                          + 3)])
        assert len(evals) == graphs.WARMUP + 3
    else:
        head, tail, wps, T0, rots = _problem(N=4)
        (_, _, res), evals, moved, keys = _count(
            lambda: midend.get_ori_traj(Config(**CONF), head, tail, wps, T0,
                                        rot_refs=rots, max_iters=6))
        assert len(evals) == res.n_evals > graphs.WARMUP
    assert moved == {"replay": 0, "capture": 0, "eager": len(evals)}
    assert keys == 0
    assert all(s.attrs["graph"] == "eager" for s in evals)


def _key(N=4, att=True, params=None, dtype=F64, **scalars):
    kw = dict(rho_mid=200.0, weight_pr=1000.0, integral_res=8,
              weight_ar=2000.0, smooth_fac=1e-2, bridge=True)
    kw.update(scalars)
    params = params if params is not None else POSES["flat"]()
    cost = midend.MidCost(N, params=params, **kw)
    x = torch.zeros(4 * N - 3, dtype=dtype)
    refs = torch.zeros(N - 1, 3, dtype=dtype)
    att_t = torch.zeros(N + 1, 3, 3, dtype=dtype) if att else None
    return cost.key(x, refs, att_t)


KEY_CHANGES = {
    "N": dict(N=5),
    "no_attitude": dict(att=False),
    "planar_pose": dict(params=fl.PlanarPose(z_ref=1.0)),
    "other_flat_pose": dict(params=fl.FlatParams(mass=1.0)),
    "planar_height": dict(params=fl.PlanarPose(z_ref=2.0)),
    "float32": dict(dtype=torch.float32),
    "rho_mid": dict(rho_mid=100.0),
    "weight_pr": dict(weight_pr=10.0),
    "integral_res": dict(integral_res=16),
    "weight_ar": dict(weight_ar=100.0),
    "smooth_fac": dict(smooth_fac=1e-3),
    "bridge": dict(bridge=False),
}


@pytest.mark.parametrize("change", list(KEY_CHANGES))
def test_keys_differ_where_the_work_does(change):
    """A key holds every scalar the evaluation bakes in, the pose map's type
    and value, dtype and shapes: change one and the key changes; the
    tensors' values are not in it."""
    base = _key()
    assert _key() == base and hash(_key()) == hash(base)
    if change == "planar_height":
        assert _key(params=fl.PlanarPose(z_ref=1.0)) != _key(**KEY_CHANGES[
            change])
    else:
        assert _key(**KEY_CHANGES[change]) != base


# ---------------------------------------------------------------------------
# on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the graph replays there only)")
    return torch.device("cuda")


# demo 6's mid end: N = 12, 64 samples a piece, the attitude term on
CARD_CONF = dict(CONF, integralIntervs=64, mem_size=16)


def _x(x, i):
    return x + 0.02 * i * torch.sin(torch.arange(
        x.shape[-1], device=x.device, dtype=x.dtype) + i)


def _card_solve(seed, max_iters=40):
    dev = _card()
    head, tail, wps, T0, rots = _problem(12, seed, dev, torch.float32)
    _, x, res = midend.get_ori_traj(Config(**CARD_CONF), head, tail, wps,
                                    T0, rot_refs=rots, max_iters=max_iters)
    return x, res


def _eager_solve(seed, monkeypatch):
    """The solve with the graphs off: every key stays in its warm-ups."""
    with monkeypatch.context() as m:
        m.setattr(midend, "GRAPHS", GraphCache(midend._Graph))
        m.setattr(graphs, "WARMUP", 10 ** 9)
        before = midend.GRAPHS.evals["eager"]
        x, res = _card_solve(seed)
        assert midend.GRAPHS.evals["eager"] - before == res.n_evals
        return x, res


@pytest.mark.cuda
@pytest.mark.parametrize("att", [True, False], ids=["attitude", "no_att"])
def test_replays_equal_the_eager_warm_ups(att, monkeypatch):
    """The warm-ups, the capture and the replays give the eager evaluation's
    f and g of the same x, bit for bit; a replayed answer is not touched by
    later evaluations."""
    monkeypatch.setattr(midend, "GRAPHS", GraphCache(midend._Graph))
    dev = _card()
    (cg, _), x, tensors = _cost_fn(N=12, att=att, device=dev,
                                   dtype=torch.float32, conf=CARD_CONF)
    cost = _mid_cost(12, conf=CARD_CONF)
    n = graphs.WARMUP + 4
    before = dict(midend.GRAPHS.evals)
    got = [cg(_x(x, i % 3), None)[:2] for i in range(n)]
    kept = [(f.clone(), g.clone()) for f, g in got]
    torch.cuda.synchronize()
    assert {k: midend.GRAPHS.evals[k] - before[k] for k in before} == {
        "eager": graphs.WARMUP, "capture": 1,
        "replay": n - 1 - graphs.WARMUP}
    for i, ((f, g), (fk, gk)) in enumerate(zip(got, kept)):
        fe, ge = cost.value_and_grad(_x(x, i % 3), *tensors)
        assert torch.equal(f, fe) and torch.equal(g, ge), i
        assert torch.equal(f, fk) and torch.equal(g, gk), i
        # the same x as a warm-up: the replay repeats its bits
        assert torch.equal(f, got[i % 3][0]) and torch.equal(g, got[i % 3][1])


@pytest.mark.cuda
def test_a_solve_with_graphs_equals_one_without(monkeypatch):
    """A whole mid-end solve through the graph ends at the eager solve's x,
    bit for bit, after the same iterations and evaluations."""
    monkeypatch.setattr(midend, "GRAPHS", GraphCache(midend._Graph))
    xe, re = _eager_solve(0, monkeypatch)
    before = dict(midend.GRAPHS.evals)
    xg, rg = _card_solve(0)
    moved = {k: midend.GRAPHS.evals[k] - before[k] for k in before}
    assert moved["capture"] == 1 and moved["replay"] == rg.n_evals - 1 \
        - graphs.WARMUP
    assert (rg.n_iters, rg.n_evals) == (re.n_iters, re.n_evals)
    assert torch.equal(xg, xe) and torch.equal(rg.f, re.f)


@pytest.mark.cuda
def test_a_cached_key_takes_a_new_problem(monkeypatch):
    """Two solves in a row with other boundary states, waypoints and
    attitude references and the same N: the second replays the first's
    graph from its first evaluation and ends at its own eager answer."""
    monkeypatch.setattr(midend, "GRAPHS", GraphCache(midend._Graph))
    x1, _ = _card_solve(0)
    before = dict(midend.GRAPHS.evals)
    x2, r2 = _card_solve(7)
    assert len(midend.GRAPHS.entries) == 1
    assert {k: midend.GRAPHS.evals[k] - before[k] for k in before} == {
        "eager": 0, "capture": 0, "replay": r2.n_evals}
    xe1, _ = _eager_solve(0, monkeypatch)
    xe2, _ = _eager_solve(7, monkeypatch)
    assert torch.equal(x1, xe1) and torch.equal(x2, xe2)
    assert not torch.equal(x1, x2)
