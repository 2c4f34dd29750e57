"""K5 (sweep/pieces.py): the trajectory's state at given times and its
gradient.

On the CPU: the kernel's closed-form backward in PyTorch operations
(``pvaj_backward_ref``) against autograd through ``pvaj_tables`` in
float64, ties of the clip included; ``pvaj_at`` on CPU tensors is
``pvaj_tables`` unchanged; the benchmark's readers of the ``pieces`` span
attribute.  On the card (``cuda``): the forward bitwise ``pvaj_tables``,
the backward within a band of float64 autograd, deterministic, under a CUDA
graph, and ``sweep_value`` at the benchmark cells' shapes against the path
through ``pvaj_components``.

This file imports neither JAX nor isdf_tpu:

    python -m pytest --noconftest tests/test_torch_pieces.py -q
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from isdf_torch.config import Config
from isdf_torch.core import flatness as fl
from isdf_torch.core import minco
from isdf_torch.core.poly import PolyTraj
from isdf_torch.shapes import make_shape
from isdf_torch.sweep import fused_zoom, pieces
from isdf_torch.sweep.fast_eval import (
    pose_components, pvaj_components, pvaj_tables, rel_components)
from isdf_torch.sweep.sweep_sdf import sweep_value
from isdf_torch.utils import obs

F64 = torch.float64
ROOT = Path(__file__).resolve().parents[1]
# float32 gradients against float64 autograd, as a share of each gradient
# tensor's largest entry: a piece's gradient sums ~10^2-10^3 float32
# products, taken in another order than autograd's (the tile, then the
# tiles, against a sorted serial sum).  Measured on an H100: up to 2.6e-7
# (float32) and 1.2e-15 (float64); the bands leave ~20x
BAND32 = 5e-6
BAND64 = 1e-13          # the same in float64


def _tables(N, B=None, dtype=F64, dev="cpu", seed=0):
    """Dyadic piece durations, so that starts, cumulative ends and the
    times set on them are exact in float32 and float64 alike (a tie of the
    clip is then a tie in both), and random coefficients → (starts, durs,
    cum, coeffs), with a leading B where given."""
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    durs = rng.integers(2, 9, size=lead + (N,)) / 4.0
    coeffs = rng.normal(size=lead + (N, 6, 3))
    d = torch.as_tensor(durs, dtype=dtype, device=dev)
    cum = torch.cumsum(d, -1)
    return (cum - d, d, cum,
            torch.as_tensor(coeffs, dtype=dtype, device=dev))


def _times(cum, M, seed=1):
    """M times of each trajectory: 0, the total, every boundary, three
    outside [0, total], the rest uniform in it."""
    rng = np.random.default_rng(seed)
    rows = cum.reshape(-1, cum.shape[-1]).cpu().numpy()
    out = []
    for c in rows:
        total = c[-1]
        special = np.concatenate([[0.0, total], c[:-1],
                                  [-0.5, total + 0.25, total + 3.0]])
        rest = rng.uniform(0.0, total, size=M - special.size)
        out.append(rng.permutation(np.concatenate([special, rest])))
    t = np.stack(out) if cum.dim() == 2 else out[0]
    return torch.as_tensor(t, dtype=cum.dtype, device=cum.device)


def _flat9(out):
    return [c for order in out for c in order]


def _autograd(starts, durs, cum, coeffs, t, w):
    """∂/∂(starts, durs, coeffs, t) of Σ wᵢ·outᵢ through pvaj_tables."""
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (starts, durs, coeffs, t)]
    s, d, c, tt = leaves
    out = _flat9(pvaj_tables(s, d, cum, c, tt))
    f = sum((o * wi).sum() for o, wi in zip(out, w))
    return torch.autograd.grad(f, leaves)


@pytest.mark.parametrize("B,N,M", [(None, 13, 64), (3, 4, 40), (None, 1, 12),
                                   (2, 1, 10)])
def test_backward_ref_matches_autograd(B, N, M):
    """The kernel's closed-form backward, per piece by index_add_, against
    autograd through pvaj_tables in float64: at 0, the total and every
    boundary the clip's operands tie and the gradient splits half and
    half; outside [0, total] the clamp holds."""
    starts, durs, cum, coeffs = _tables(N, B)
    t = _times(cum, M)
    rng = np.random.default_rng(2)
    w = [torch.as_tensor(rng.normal(size=tuple(t.shape)), dtype=F64)
         for _ in range(9)]
    w[4] = None                       # a component autograd brings no grad to
    ref = _autograd(starts, durs, cum, coeffs, t,
                    [torch.zeros_like(t) if x is None else x for x in w])
    got = pieces.pvaj_backward_ref(starts, durs, cum, coeffs, t, w)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("batched", [False, True])
def test_pvaj_at_on_cpu_is_pvaj_tables(batched):
    """CPU tensors run pvaj_tables unchanged, bitwise, values and
    gradients, and launch nothing."""
    starts, durs, cum, coeffs = _tables(5, 3 if batched else None)
    t = _times(cum, 20)
    before = (pieces.LAUNCHES, pieces.LAUNCHES_BACKWARD)
    d1 = durs.clone().requires_grad_(True)
    c1 = coeffs.clone().requires_grad_(True)
    got = pieces.pvaj_at(PolyTraj(d1, c1), t)
    d2 = durs.clone().requires_grad_(True)
    c2 = coeffs.clone().requires_grad_(True)
    want = pvaj_components(PolyTraj(d2, c2), t, n_orders=3)[:3]
    assert len(got) == 3
    for a, b in zip(_flat9(got), _flat9(want)):
        assert torch.equal(a, b)
    ga = torch.autograd.grad(sum(c.sum() for c in _flat9(got)), (d1, c1))
    gb = torch.autograd.grad(sum(c.sum() for c in _flat9(want)), (d2, c2))
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)
    assert (pieces.LAUNCHES, pieces.LAUNCHES_BACKWARD) == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(fused_zoom.shutil, "which", lambda name: None)
    monkeypatch.setattr(fused_zoom.os.path, "exists", lambda p: False)
    monkeypatch.setattr(fused_zoom, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        pieces.build()


def _reader(name):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "test_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name,root,count", [
    ("piece_kernel_pct.plan", "plan", "profiled_plans"),
    ("piece_kernel_pct.batch", "batch.solve", "profiled_solves")])
def test_piece_kernel_readers(name, root, count):
    """100 where every back_end.eval span ran the kernel, 50 for half,
    None where the attribute is missing (a program without it)."""
    read = _reader(name)

    def share(attrs):
        obs.clear()
        with obs.tracing():
            with obs.span(root):
                for a in attrs:
                    with obs.span("back_end.eval") as s:
                        s.set(graph="replay", **a)
        try:
            return read({count: 1})
        finally:
            obs.clear()

    assert share([{"pieces": "kernel"}] * 4) == 100.0
    assert share([{"pieces": "kernel"}, {"pieces": "torch"}] * 2) == 50.0
    assert share([{}] * 3) is None
    assert share([{"pieces": "kernel"}, {}]) is None


def test_back_end_eval_span_names_the_torch_path_on_cpu():
    """A CPU evaluation runs pvaj_tables: every back_end.eval span says
    ``pieces="torch"``."""
    from isdf_torch.opt import backend
    conf = Config(poly_params=(0.0,) * 6)
    shape, params = make_shape("Ball", conf), fl.FlatParams.from_config(conf)
    w = backend.BackendWeights.from_config(conf)
    N, P = 3, 16
    rng = np.random.default_rng(0)
    head = torch.zeros(3, 3, dtype=F64)
    tail = torch.zeros(3, 3, dtype=F64)
    tail[:, 0] = torch.tensor([3.0, 1.0, 0.5])
    pts = torch.as_tensor(rng.uniform(-1, 4, size=(P, 3)), dtype=F64)
    fn = backend.make_cost_fn(shape, params, w, head, tail, N, pts,
                              torch.ones(P, dtype=torch.bool),
                              integral_res=4, coarse_n=16, refine_rounds=4)
    x = torch.as_tensor(np.concatenate([np.zeros(N), rng.normal(
        size=3 * (N - 1))]), dtype=F64)
    obs.clear()
    with obs.tracing():
        fn(x, torch.zeros(P, dtype=F64))
    evals = [s for s in obs.spans() if s.name == "back_end.eval"]
    obs.clear()
    assert evals and all(s.attrs["pieces"] == "torch" for s in evals)


# ---------------------------------------------------------------------------
# on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K5 has no interpret mode)")
    return torch.device("cuda")


CASES = {                       # (B, N, M): the cells' shapes and the ends
    "plan": (None, 13, 4096),   # demo6.plan: one trajectory, P = 4096
    "batch": (4096, 4, 512),    # demo*.batch4096
    "one_piece": (None, 1, 300),
    "max_pieces": (None, fused_zoom.MAX_PIECES, 3000),
    "batch_max": (3, fused_zoom.MAX_PIECES, 700),
    # past K1-K3's limit of pieces, which K5 does not share
    "long": (None, 1000, 6000),
    "batch_long": (2, 300, 1200),
}


def _card_inputs(case, dtype, dev):
    B, N, M = CASES[case]
    starts, durs, cum, coeffs = _tables(N, B, dtype, dev)
    return starts, durs, cum, coeffs, _times(cum, M)


def _launch(durs, coeffs, t):
    return _flat9(pieces.pvaj_at(PolyTraj(durs, coeffs), t))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_is_bitwise_pvaj_tables_on_card(case, dtype):
    """One launch, bitwise pvaj_tables on the card, ties and times outside
    [0, total] included."""
    dev = _card()
    starts, durs, cum, coeffs, t = _card_inputs(case, dtype, dev)
    before = pieces.LAUNCHES
    got = _launch(durs, coeffs, t)
    assert pieces.LAUNCHES == before + 1
    want = _flat9(pvaj_tables(starts, durs, cum, coeffs, t))
    for a, b in zip(got, want):
        assert a.shape == t.shape and torch.equal(a, b)


def _rel_err(a, ref):
    return float((a.double() - ref).abs().max() / ref.abs().max().clamp_min(
        1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, F64])
@pytest.mark.parametrize("case", list(CASES))
def test_gradients_within_band_of_float64_autograd_on_card(case, dtype):
    """∂/∂(starts, durs, coeffs, t) within BAND32 (float32) or BAND64 of
    float64 autograd through pvaj_tables on the same values; the float32
    plain path's own error is printed beside."""
    dev = _card()
    starts, durs, cum, coeffs, t = _card_inputs(case, dtype, dev)
    rng = np.random.default_rng(3)
    w = [torch.as_tensor(rng.normal(size=tuple(t.shape)), dtype=dtype,
                         device=dev) for _ in range(9)]
    leaves = [x.clone().requires_grad_(True) for x in (durs, coeffs, t)]
    d, c, tt = leaves
    out = _launch(d, c, tt)
    before = pieces.LAUNCHES_BACKWARD
    got = torch.autograd.grad(sum((o * wi).sum() for o, wi in zip(out, w)),
                              leaves)
    assert pieces.LAUNCHES_BACKWARD == before + 1
    d64 = durs.double().requires_grad_(True)
    c64 = coeffs.double().requires_grad_(True)
    t64 = t.double().requires_grad_(True)
    cum64 = torch.cumsum(d64, -1)
    ref_out = _flat9(pvaj_tables(cum64 - d64, d64, cum64.detach(), c64, t64))
    ref = torch.autograd.grad(sum((o * wi.double()).sum()
                                  for o, wi in zip(ref_out, w)),
                              (d64, c64, t64))
    band = BAND32 if dtype == torch.float32 else BAND64
    errs = [_rel_err(a, b) for a, b in zip(got, ref)]
    print(f"K5 {case} {dtype}: gradient errors (durs, coeffs, t) {errs}")
    assert max(errs) <= band


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plan", "batch", "max_pieces"])
def test_backward_is_deterministic_and_replays_in_a_graph_on_card(case):
    """Two backward calls give the same bits, and a CUDA graph of the
    forward and backward replays to the eager answer."""
    dev = _card()
    starts, durs, cum, coeffs, t = _card_inputs(case, torch.float32, dev)
    rng = np.random.default_rng(4)
    w = [torch.as_tensor(rng.normal(size=tuple(t.shape)), dtype=torch.float32,
                         device=dev) for _ in range(9)]

    def grads(d, c):
        leaves = [d.detach().requires_grad_(True),
                  c.detach().requires_grad_(True)]
        out = _launch(leaves[0], leaves[1], t)
        g = torch.autograd.grad(sum((o * wi).sum() for o, wi in
                                    zip(out, w)), leaves)
        return torch.cat([x.reshape(-1) for x in g + tuple(out)])

    first, second = grads(durs, coeffs), grads(durs, coeffs)
    assert torch.equal(first, second)
    sd, sc = durs.clone(), coeffs.clone()
    for _ in range(2):
        grads(sd, sc)                          # warm-ups
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = grads(sd, sc)
    sd.copy_(durs * 1.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static, first)


def _cell_traj(B, N, dev, seed=0):
    """A MINCO trajectory through N − 1 random waypoints (a batch of B),
    float32, with grad."""
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    q = (np.linspace(1, 8, N - 1)[:, None] * np.array([1.0, 0.3, 0.15])
         + rng.normal(scale=0.3, size=lead + (N - 1, 3)))
    T = torch.as_tensor(rng.uniform(0.8, 2.2, size=lead + (N,)),
                        dtype=torch.float32, device=dev)
    tail = torch.zeros(lead + (3, 3), dtype=torch.float32, device=dev)
    tail[..., 0] = torch.tensor([9.0, 2.5, 1.2], device=dev)
    coeffs = minco.solve(torch.as_tensor(q, dtype=torch.float32, device=dev),
                         T, torch.zeros_like(tail), tail)
    return T.detach(), coeffs.detach()


def _old_sweep_value(shape, traj, params, p_eva, kout):
    """sweep_value as it ran through pvaj_components."""
    t_star, d0, g0 = kout
    pw = (p_eva[..., 0], p_eva[..., 1], p_eva[..., 2])
    pos, vel, acc, _ = pvaj_components(traj, t_star, n_orders=3)
    rx, ry, rz = rel_components(pw, *pose_components(pos, vel, acc, params))
    if shape.grid is None:
        return shape.sdf3_fn()(rx, ry, rz)
    return (d0 + g0[..., 0] * (rx - rx.detach())
            + g0[..., 1] * (ry - ry.detach())
            + g0[..., 2] * (rz - rz.detach()))


@pytest.mark.cuda
@pytest.mark.parametrize("cell,B,N,P", [("demo6.plan", None, 13, 4096),
                                        ("demo1.batch4096", 4096, 4, 512),
                                        ("demo6.batch4096", 4096, 4, 512)])
def test_sweep_value_matches_the_pvaj_components_path_on_card(cell, B, N, P):
    """The swept SDF's value at t* bitwise, its gradient in the durations
    and coefficients within BAND32 of the path through pvaj_components,
    at the cells' shapes (t* random in [0, total] with 0, the total and
    the boundaries among them)."""
    dev = _card()
    T, coeffs = _cell_traj(B, N, dev)
    rng = np.random.default_rng(5)
    lead = () if B is None else (B,)
    pts = torch.as_tensor(rng.uniform(-1, 10, size=lead + (P, 3)),
                          dtype=torch.float32, device=dev)
    t_star = _times(torch.cumsum(T, -1), P)
    d0 = torch.as_tensor(rng.normal(size=lead + (P,)), dtype=torch.float32,
                         device=dev)
    g0 = torch.as_tensor(rng.normal(size=lead + (P, 3)), dtype=torch.float32,
                         device=dev)
    if cell.startswith("demo1"):
        conf = Config(poly_params=(0.0, 0.0, 0.0, 120.0, 0.0, 0.0))
        shape = make_shape("RoundedCone", conf)
    else:
        conf = Config()
        shape = SimpleNamespace(grid=object())    # K3's linearisation
    params = fl.FlatParams.from_config(conf)
    wts = torch.as_tensor(rng.uniform(0.5, 1.5, size=lead + (P,)),
                          dtype=torch.float32, device=dev)

    def run(fn):
        d = T.clone().requires_grad_(True)
        c = coeffs.clone().requires_grad_(True)
        v = fn(shape, PolyTraj(d, c), params, pts, (t_star, d0, g0))
        return (v.detach(),) + torch.autograd.grad((v * wts).sum(), (d, c))

    before = pieces.LAUNCHES
    new = run(sweep_value)
    assert pieces.LAUNCHES == before + 1
    old = run(_old_sweep_value)
    assert torch.equal(new[0], old[0])
    errs = [_rel_err(a, b.double()) for a, b in zip(new[1:], old[1:])]
    print(f"sweep_value {cell}: gradient differences (durs, coeffs) {errs}")
    assert max(errs) <= BAND32
