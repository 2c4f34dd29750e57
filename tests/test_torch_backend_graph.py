"""The back end's evaluation cut at the sweep kernel (``backend.SplitCost``)
and the CUDA graphs that replay its two sides (``backend._Graphs``, kept in
``backend.GRAPHS``; their lifecycle is ``tests/test_torch_graphs.py``'s).

On the CPU: the cut evaluation gives the one-piece evaluation's f, g, t* and
breakdown bit for bit on the kernels' plain versions (K3 on the L mesh, K1
on the RoundedCone and under PlanarPose, K2 and batched K3 at B = 4, the
attitude term); every CPU evaluation runs eagerly, also with an "sp" group
and on the non-fused sweep, and makes no capture.  On the card (``cuda``):
replayed answers against the one-piece ones, static inputs refreshed for a
new problem, no aliasing across evaluations, one kernel call and launch an
evaluation."""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from isdf_torch.config import Config
from isdf_torch.core import flatness as fl
from isdf_torch.core import timemap
from isdf_torch.opt import backend, graphs
from isdf_torch.opt.attitude import pad_attitude_refs
from isdf_torch.opt.graphs import GraphCache
from isdf_torch.parallel import batch as pb
from isdf_torch.shapes import grid_shape, make_shape
from isdf_torch.shapes import mesh as meshlib
from isdf_torch.sweep import fused_zoom, grid_zoom
from isdf_torch.sweep.sweep_sdf import kernel_ok
from isdf_torch.utils import obs

F64 = torch.float64
CONF = dict(integralIntervs=8, sweep_coarse_samples=64,
            sweep_refine_rounds=4, vmax=5.0, omgmax=5.0, thetamax=1.5,
            safety_hor=0.4, mem_size=8)
EVAL_PARTS = {"eval.sweep"}


def _l_shape(device, res, margin):
    V, F = meshlib.l_prism()
    field, origin, r = meshlib.bake_sdf_grid(V, F, res, margin,
                                             device=device)
    return grid_shape("Lthick", field, origin, r, device=device)


def _problem(body, B=None, N=3, P=48, seed=0, device="cpu", dtype=F64,
             conf=None, att=False, l_res=0.1):
    """(shape, pose map, make_cost_fn keywords, x, t_warm, CostData) of a
    random problem; B None: one trajectory."""
    conf = Config(**(conf or CONF))
    batch = pb.make_random_batch(conf, B or 1, N=N, n_points=P, seed=seed,
                                 device=device, dtype=dtype)
    if B is None:
        batch = batch.map(lambda t: t[0])
    shape = _l_shape(device, l_res, 3 * l_res) if body == "L" \
        else make_shape(body, conf)
    params = fl.PlanarPose(z_ref=1.0) if body == "Box" \
        else fl.FlatParams.from_config(conf)
    rng = np.random.default_rng(seed + 1)
    T = batch.T0 * torch.as_tensor(rng.uniform(0.8, 1.2, batch.T0.shape),
                                   dtype=dtype, device=device)
    x = backend.pack(timemap.T_to_tau(T), batch.q0)
    tw = torch.as_tensor(rng.uniform(0.0, 2.0, batch.mask.shape),
                         dtype=dtype, device=device)
    mask = batch.mask.clone()
    mask[..., ::7] = False
    refs = None
    kw = dict(integral_res=conf.integralIntervs,
              coarse_n=conf.sweep_coarse_samples,
              refine_rounds=conf.sweep_refine_rounds)
    if att:
        ang = rng.uniform(-0.4, 0.4, size=(N - 1, 3))
        Rs = np.stack([_rot(a) for a in ang])
        refs = pad_attitude_refs(Rs, dtype, torch.device(device))
        kw.update(att=refs, weight_ar=50.0)
    data = backend.CostData(batch.head, batch.tail, batch.points, mask, refs)
    w = backend.BackendWeights.from_config(conf)
    args = (shape, params, w, batch.head, batch.tail, N, batch.points, mask)
    return args, kw, x, tw, data


def _rot(a):
    cx, sx = np.cos(a[0]), np.sin(a[0])
    cz, sz = np.cos(a[2]), np.sin(a[2])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Rx


def _split(args, kw):
    shape, params, w, _, _, N = args[:6]
    return backend.SplitCost(shape, params, w, N, kw["integral_res"],
                             kw["coarse_n"], kw["refine_rounds"],
                             kw.get("weight_ar", 0.0))


def _cut(args, kw, x, tw, data):
    """The cut evaluation's three steps, eagerly → (f, g, t*, breakdown)."""
    split = _split(args, kw)
    kout = split.launch(split.kernel_args(x, tw, data), x.dtype)
    f, g, bd = split.remainder(x, data, kout)
    return f, g, kout[0], bd


def _one_piece(args, kw, x, tw, lib=None):
    """The one-piece evaluation: the graphs stand aside where the sweep on
    the back end's module is not the sweep module's own.  ``lib``: the
    card's linear-algebra library for it ("cusolver": a batch's key)."""
    real = backend.sweep_sdf_warm
    backend.sweep_sdf_warm = lambda *a, **k: real(*a, **k)
    try:
        _, _, cg = backend.make_cost_fn(*args, with_breakdown=True, **kw)
        with backend._linalg(lib):
            f, g, (t, bd) = cg(x, (tw, None))
    finally:
        backend.sweep_sdf_warm = real
    return f, g, t, bd


def _equal(a, b):
    fa, ga, ta, bda = a
    fb, gb, tb, bdb = b
    assert torch.equal(fa, fb) and torch.equal(ga, gb)
    assert torch.equal(ta, tb)
    for u, v in zip(bda, bdb):
        assert torch.equal(u, v)


CASES = {
    "L-K3": dict(body="L"),
    "RoundedCone-K1": dict(body="RoundedCone"),
    "planar-Box-K1": dict(body="Box"),
    "batched-Ball-K2": dict(body="Ball", B=4),
    "batched-L-K3": dict(body="L", B=4),
    "attitude-RoundedCone-K1": dict(body="RoundedCone", att=True),
    "float32-L-K3": dict(body="L", dtype=torch.float32),
}


@pytest.mark.parametrize("case", list(CASES))
def test_split_evaluation_equals_the_one_piece(case):
    """(a) kernel inputs, (b) the kernel, (c) the rest with its gradient,
    run eagerly, against the one-piece evaluation: bit for bit."""
    args, kw, x, tw, data = _problem(**CASES[case])
    one = _one_piece(args, kw, x, tw)
    cut = _cut(args, kw, x, tw, data)
    _equal(cut, one)
    f, g, t, bd = cut
    assert torch.isfinite(g).all() and float(bd.safety.sum()) > 0.0
    assert t.shape == data.mask.shape and g.shape == x.shape
    assert torch.equal(bd.total, bd.energy + bd.time + bd.dyn + bd.safety)


@pytest.mark.parametrize("case", list(CASES))
def test_split_kernel_inputs_are_the_one_piece_sweeps(case, monkeypatch):
    """The kernel sees the same arguments from the cut's step (a) as from
    the one-piece sweep, in one call an evaluation, on its module's
    attribute."""
    args, kw, x, tw, data = _problem(**CASES[case])
    seen = []
    for mod, attr in ((fused_zoom, "sweep_warm_fused"),
                      (fused_zoom, "sweep_warm_fused_batched"),
                      (grid_zoom, "grid_sweep_warm_fused"),
                      (grid_zoom, "grid_sweep_warm_fused_batched")):
        def rec(*a, _fn=getattr(mod, attr), **k):
            seen.append((a[2:], k))
            return _fn(*a, **k)
        monkeypatch.setattr(mod, attr, rec)
    _one_piece(args, kw, x, tw)
    _cut(args, kw, x, tw, data)
    assert len(seen) == 2
    (a1, k1), (a2, k2) = seen
    assert k1 == k2 and len(a1) == len(a2)
    for u, v in zip(a1, a2):
        assert torch.equal(u, v)


def _count(fn, *a):
    before = dict(backend.GRAPHS.evals)
    keys = len(backend.GRAPHS.entries)
    obs.clear()
    with obs.tracing():
        out = fn(*a)
    evals = [s for s in obs.spans() if s.name == "back_end.eval"]
    moved = {k: backend.GRAPHS.evals[k] - before[k] for k in before}
    return out, evals, moved, len(backend.GRAPHS.entries) - keys


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def sp_group():
    """A one-rank gloo group, as a mesh's "sp" group would be."""
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{_free_port()}",
                                rank=0, world_size=1)
    try:
        yield dist.new_group([0])
    finally:
        if own:
            dist.destroy_process_group()


@pytest.mark.parametrize("how", ["cpu", "sp_group", "non_fused_coarse",
                                 "no_spec", "lockstep"])
def test_graphs_stand_aside(how, request):
    """Every CPU evaluation runs eagerly and captures nothing: the one-piece
    evaluation with its sweep as its one part, its ``back_end.eval`` span
    marked ``graph = eager``, the eager counter up by one an evaluation."""
    conf = dict(CONF)
    body = "Ball"
    if how == "non_fused_coarse":
        conf["sweep_coarse_samples"] = 60
    args, kw, x, tw, data = _problem(body, conf=conf,
                                     B=4 if how == "lockstep" else None)
    if how == "sp_group":
        kw["sp_group"] = request.getfixturevalue("sp_group")
    if how == "no_spec":
        shape = args[0]
        args = (type(shape)(shape.name, shape.sdf, shape.bounds),) + args[1:]
    assert kernel_ok(args[0], kw["coarse_n"]) == (
        how in ("cpu", "sp_group", "lockstep"))
    cg = backend.make_cost_fn(*args, **kw)
    if how == "lockstep":
        _, evals, moved, keys = _count(
            lambda: pb._lockstep(Config(**CONF), cg, x, tw, 2))
    else:
        _, evals, moved, keys = _count(
            lambda: [cg(x + 0.01 * i, tw) for i in range(3)])
    assert len(evals) >= 3
    assert moved == {"replay": 0, "capture": 0, "eager": len(evals)}
    assert keys == 0
    spans = obs.spans()
    for s in evals:
        assert s.attrs["graph"] == "eager"
        assert {c.name for c in spans if c.parent == s.id} == EVAL_PARTS


# ---------------------------------------------------------------------------
# on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the graphs replay there only)")
    return torch.device("cuda")


CARD = {
    # demo 6's body and sizes: the L baked at 0.05 m, N = 12, P = 4096
    "K3-demo6": dict(body="L", N=12, P=4096),
    # demo 1's: the posed RoundedCone, N = 12, P = 4096
    "K1-demo1": dict(body="RoundedCone", N=12, P=4096),
    "K2-B256": dict(body="RoundedCone", B=256, N=4, P=512),
    "K3-B64": dict(body="L", B=64, N=4, P=512),
}
CARD_CONF = dict(CONF, integralIntervs=64, sweep_coarse_samples=128,
                 sweep_refine_rounds=24)


def _card_problem(case, seed=0):
    dev = _card()
    spec = dict(CARD[case])
    return _problem(**spec, seed=seed, device=dev, dtype=torch.float32,
                    conf=CARD_CONF, l_res=0.05)


def _x(x, i):
    return x + 0.02 * i * torch.sin(torch.arange(
        x.shape[-1], device=x.device, dtype=x.dtype) + i)


def _evals(cg, x, tw, n):
    """n evaluations along x, each warm-started at the last t*."""
    out = []
    for i in range(n):
        f, g, t = cg(_x(x, i), tw)
        out.append((f, g, t, tw))
        tw = t
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD))
def test_replayed_evaluations_equal_the_eager_ones(case, monkeypatch):
    """Warm-up, capture and replays against the one-piece evaluation of
    the same x and warm seeds; one kernel call (on the module attribute, as
    the benchmark's recorder sees it) and one launch an evaluation."""
    monkeypatch.setattr(backend, "GRAPHS", GraphCache(backend._Graphs))
    args, kw, x, tw, data = _card_problem(case)
    calls = []
    mod, attr, counter = {
        "K3-demo6": (grid_zoom, "grid_sweep_warm_fused", "LAUNCHES_GRID"),
        "K1-demo1": (fused_zoom, "sweep_warm_fused", "LAUNCHES"),
        "K2-B256": (fused_zoom, "sweep_warm_fused_batched",
                    "LAUNCHES_BATCHED"),
        "K3-B64": (grid_zoom, "grid_sweep_warm_fused_batched",
                   "LAUNCHES_GRID")}[case]
    fn = getattr(mod, attr)
    monkeypatch.setattr(mod, attr,
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    cg = backend.make_cost_fn(*args, **kw)
    n = graphs.WARMUP + 4
    launches = getattr(mod, counter)
    before = dict(backend.GRAPHS.evals)
    got = _evals(cg, x, tw, n)
    torch.cuda.synchronize()
    assert len(calls) == n and getattr(mod, counter) == launches + n
    assert {k: backend.GRAPHS.evals[k] - before[k] for k in before} == {
        "eager": graphs.WARMUP, "capture": 1, "replay": n - 1 -
        graphs.WARMUP}
    for i, (f, g, t, tw_i) in enumerate(got):
        # a batch's key runs under cuSOLVER's library, warm-ups too
        lib = "cusolver" if x.dim() == 2 else None
        fe, ge, te, _ = _one_piece(args, kw, _x(x, i), tw_i, lib)
        assert torch.equal(f, fe), (i, f, fe)
        assert torch.equal(g, ge), (i, (g - ge).abs().max())
        assert torch.equal(t, te), i
        fd, gd, _, _ = _one_piece(args, kw, _x(x, i), tw_i)
        torch.testing.assert_close(f, fd, rtol=1e-5, atol=0)
        torch.testing.assert_close(g, gd, rtol=1e-4,
                                   atol=1e-5 * float(gd.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["K3-demo6", "K2-B256"])
def test_a_cached_key_takes_a_new_problem(case, monkeypatch):
    """A second solve's points, mask, boundary states and warm seeds reach
    the captured graphs: its answers are its eager ones, and an earlier
    answer is untouched by later evaluations."""
    monkeypatch.setattr(backend, "GRAPHS", GraphCache(backend._Graphs))
    args, kw, x, tw, _ = _card_problem(case, seed=0)
    first = _evals(backend.make_cost_fn(*args, **kw), x, tw,
                   graphs.WARMUP + 2)
    kept = [tuple(a.clone() for a in r[:3]) for r in first]
    args2, kw2, x2, tw2, _ = _card_problem(case, seed=3)
    args2 = (args[0],) + args2[1:]           # the same shape: the same key
    before = dict(backend.GRAPHS.evals)
    cg2 = backend.make_cost_fn(*args2, **kw2)
    second = _evals(cg2, x2, tw2, 3)
    assert backend.GRAPHS.evals["replay"] - before["replay"] == 3
    for i, (f, g, t, tw_i) in enumerate(second):
        fe, ge, te, _ = _one_piece(args2, kw2, _x(x2, i), tw_i,
                                   "cusolver" if x2.dim() == 2 else None)
        assert torch.equal(f, fe) and torch.equal(g, ge)
        assert torch.equal(t, te)
    for r, k in zip(first, kept):
        for a, b in zip(r[:3], k):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["K2-B256", "K3-B64"])
def test_a_batch_key_replays_its_warm_ups_bit_for_bit(case, monkeypatch):
    """A key's first solve (eager warm-ups, then the capture) and a later
    solve of the same problem (all replays) give the same bits, as the
    dp dryrun's check that a solve does not depend on placement needs."""
    monkeypatch.setattr(backend, "GRAPHS", GraphCache(backend._Graphs))
    args, kw, x, tw, _ = _card_problem(case)
    n = graphs.WARMUP + 2
    first = _evals(backend.make_cost_fn(*args, **kw), x, tw, n)
    before = backend.GRAPHS.evals["replay"]
    again = _evals(backend.make_cost_fn(*args, **kw), x, tw, n)
    assert backend.GRAPHS.evals["replay"] - before == n
    for a, b in zip(first, again):
        for u, v in zip(a, b):
            assert torch.equal(u, v)


@pytest.mark.cuda
def test_the_non_fused_sweep_stays_eager_on_the_card(monkeypatch):
    monkeypatch.setattr(backend, "GRAPHS", GraphCache(backend._Graphs))
    args, kw, x, tw, _ = _card_problem("K1-demo1")
    kw = dict(kw, coarse_n=60)
    before = dict(backend.GRAPHS.evals)
    _evals(backend.make_cost_fn(*args, **kw), x, tw, graphs.WARMUP + 2)
    assert backend.GRAPHS.evals["eager"] - before["eager"] == \
        graphs.WARMUP + 2
    assert not backend.GRAPHS.entries
