"""isdf_torch.parallel.batch against isdf_tpu.parallel.batch, and the port's
leading-B forms of the core against loops of its single-scenario forms,
float64 on the CPU (where K2's wrapper runs its plain version)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isdf_tpu.config import Config as JConfig
from isdf_tpu.parallel import batch as jpb
from isdf_tpu.shapes import make_shape as jmake_shape

from isdf_torch.config import Config
from isdf_torch.core import flatness as fl
from isdf_torch.core import minco, timemap
from isdf_torch.core.poly import PolyTraj
from isdf_torch.opt import backend
from isdf_torch.parallel import batch as pb
from isdf_torch.shapes import make_shape
from isdf_torch.sweep import fused_zoom
from isdf_torch.sweep.fast_eval import pvaj_components
from isdf_torch.sweep.sweep_sdf import sweep_sdf

F64 = torch.float64
CONF = dict(integralIntervs=16, sweep_coarse_samples=32,
            sweep_refine_rounds=8, mem_size=8, vmax=5.0, omgmax=5.0,
            thetamax=1.5, safety_hor=0.4)
FIELDS = ("head", "tail", "q0", "T0", "points", "mask")


def _batch(B=4, N=3, P=16, seed=0, **kw):
    conf = Config(**{**CONF, **kw})
    return conf, pb.make_random_batch(conf, B, N=N, n_points=P, seed=seed,
                                      device="cpu", dtype=F64)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_make_random_batch_matches_jax(dtype):
    """Same numpy draws in the same order: every field equal bit for bit."""
    jb = jpb.make_random_batch(JConfig(**CONF), 5, N=4, n_points=12, seed=3,
                               dtype=getattr(jnp, dtype))
    tb = pb.make_random_batch(Config(**CONF), 5, N=4, n_points=12, seed=3,
                              device="cpu", dtype=getattr(torch, dtype))
    for name in FIELDS:
        a, b = np.asarray(getattr(jb, name)), getattr(tb, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the state carried across: a JAX batch's fields as numpy arrays
    tb2 = pb.ScenarioBatch.from_arrays(
        *(np.asarray(getattr(jb, n)) for n in FIELDS), device="cpu",
        dtype=getattr(torch, dtype))
    for name in FIELDS:
        assert torch.equal(getattr(tb2, name), getattr(tb, name))
    with pytest.raises(ValueError, match="q0"):
        pb.ScenarioBatch.from_arrays(tb.head, tb.tail, tb.q0[:, :-1], tb.T0,
                                     tb.points, tb.mask, device="cpu")


def _perturbed(batch, seed=5):
    """Durations that differ per scenario and piece."""
    rng = np.random.default_rng(seed)
    return batch.T0 * torch.as_tensor(rng.uniform(0.6, 1.4,
                                                  size=batch.T0.shape))


def test_batched_minco_and_polytraj_equal_single_loops():
    """rtol 1e-10: the same arithmetic, the solve batched by LAPACK."""
    _, batch = _batch()
    T = _perturbed(batch)
    B = T.shape[0]
    A, rhs = minco.build_system(batch.q0, T, batch.head, batch.tail)
    coeffs = minco.solve(batch.q0, T, batch.head, batch.tail)
    energy = minco.energy(coeffs, T)
    traj = PolyTraj(T, coeffs)
    rng = np.random.default_rng(6)
    ts = torch.as_tensor(rng.uniform(-0.5, 1.1, size=(B, 40))) \
        * traj.total_duration[:, None]
    idx, s = traj.locate(ts)
    pvaj = traj.pvaj(ts)
    comps = pvaj_components(traj, ts)
    junc = traj.junction_positions()
    close = lambda a, b: torch.testing.assert_close(a, b, rtol=1e-10,
                                                    atol=1e-12)
    for b in range(B):
        A1, rhs1 = minco.build_system(batch.q0[b], T[b], batch.head[b],
                                      batch.tail[b])
        assert torch.equal(A[b], A1) and torch.equal(rhs[b], rhs1)
        c1 = minco.solve(batch.q0[b], T[b], batch.head[b], batch.tail[b])
        close(coeffs[b], c1)
        close(energy[b], minco.energy(c1, T[b]))
        one = PolyTraj(T[b], coeffs[b])
        idx1, s1 = one.locate(ts[b])
        assert torch.equal(idx[b], idx1)
        close(s[b], s1)
        for a, a1 in zip(pvaj, one.pvaj(ts[b])):
            close(a[b], a1)
        for order, order1 in zip(comps, pvaj_components(one, ts[b])):
            for a, a1 in zip(order, order1):
                close(a[b], a1)
        close(junc[b], one.junction_positions())
    tau = timemap.T_to_tau(T)
    close(timemap.tau_to_T(tau), T)
    x = backend.pack(tau, batch.q0)
    tau2, q2 = backend.unpack(x, T.shape[1])
    assert torch.equal(tau2, tau) and torch.equal(q2, batch.q0)
    assert torch.equal(x[1], backend.pack(tau[1], batch.q0[1]))


@pytest.mark.parametrize("name", ["Ball", "CSG"])
def test_batched_cost_equals_single_loops(name):
    """The per-scenario cost (B,) and its gradient against the
    single-scenario cost function on each scenario, rtol 1e-10."""
    conf, batch = _batch()
    shape = make_shape(name, conf)
    params = fl.FlatParams.from_config(conf)
    w = backend.BackendWeights.from_config(conf)
    N = batch.T0.shape[1]
    x = backend.pack(timemap.T_to_tau(_perturbed(batch)), batch.q0)
    rng = np.random.default_rng(7)
    tw = torch.as_tensor(rng.uniform(0.0, 5.0, size=batch.mask.shape))
    mask = batch.mask.clone()
    mask[:, ::5] = False
    kw = dict(integral_res=conf.integralIntervs,
              coarse_n=conf.sweep_coarse_samples,
              refine_rounds=conf.sweep_refine_rounds)
    before = fused_zoom.LAUNCHES_BATCHED
    f, g, t_star = backend.make_cost_fn(
        shape, params, w, batch.head, batch.tail, N, batch.points, mask,
        **kw)(x, tw)
    assert fused_zoom.LAUNCHES_BATCHED == before     # CPU: the plain version
    assert f.shape == (4,) and g.shape == x.shape
    traj, T, _ = backend.build_traj(x, N, batch.head, batch.tail)
    dyn = backend.integral_penalty(traj, params, w, conf.integralIntervs)
    for b in range(4):
        f1, g1, t1 = backend.make_cost_fn(
            shape, params, w, batch.head[b], batch.tail[b], N,
            batch.points[b], mask[b], **kw)(x[b], tw[b])
        torch.testing.assert_close(f[b], f1, rtol=1e-10, atol=0)
        torch.testing.assert_close(g[b], g1, rtol=1e-10,
                                   atol=1e-10 * float(g1.abs().max()))
        assert torch.equal(t_star[b], t1)
        one = PolyTraj(T[b], traj.coeffs[b])
        torch.testing.assert_close(
            dyn[b], backend.integral_penalty(one, params, w,
                                             conf.integralIntervs),
            rtol=1e-10, atol=0)


def test_batched_cost_and_grad_matches_jax():
    """B = 4, N = 3, P = 16, Ball, float64, from the cold start: f to rtol
    1e-10 and g to 1e-8 of its largest entry (measured: 1e-14 and 3e-14;
    both sweeps find the same t*, the band leaves room for another BLAS)."""
    jc = JConfig(**CONF)
    jb = jpb.make_random_batch(jc, 4, N=3, n_points=16, seed=0,
                               dtype=jnp.float64)
    fj, gj = (np.asarray(a) for a in jpb.batched_cost_and_grad(
        jmake_shape("Ball", jc), jc, jb))
    conf, tb = _batch()
    ft, gt = pb.batched_cost_and_grad(make_shape("Ball", conf), conf, tb,
                                      device="cpu")
    assert fj.min() > 1e3                       # the penalties are active
    np.testing.assert_allclose(ft.numpy(), fj, rtol=1e-10)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0,
                               atol=1e-8 * np.abs(gj).max())


def test_chunked_solve_descends_and_matches_monolithic():
    """Every scenario ends below its first cost.  Chunked against one call:
    a chunk boundary only freezes a scenario, so the two give the same
    result for every scenario that stays inside the trip bounds (2·chunk + 8
    per chunk, 2·max_iters + 8 for the single call).  A scenario with many
    rejected trials gets more trips from two chunks (2 × 16) than from one
    call (24) and can take one more step there — measured here: scenario 0
    accepts 4 steps chunked and 3 in one call, the other three agree."""
    conf, batch = _batch(integralIntervs=8, sweep_coarse_samples=16,
                         sweep_refine_rounds=4)
    shape = make_shape("Ball", conf)
    f0, _ = pb.batched_cost_and_grad(shape, conf, batch, device="cpu")
    seen = []
    cc, Tc, fc, ic = pb.batched_solve_chunked(
        shape, conf, batch, max_iters=8, chunk=4, device="cpu",
        callback=lambda res: seen.append(res.n_iters.clone()))
    assert len(seen) == 1 and seen[0].shape == (4,)
    assert cc.shape == (4, 3, 6, 3) and Tc.shape == (4, 3)
    assert bool(torch.isfinite(cc).all() and torch.isfinite(fc).all())
    assert bool((fc <= f0).all()) and bool((Tc > 0).all())
    cm, Tm, fm, im = pb.batched_solve(shape, conf, batch, max_iters=8,
                                      device="cpu")
    assert bool((fm <= f0).all())
    same = ic == im
    assert int(same.sum()) >= 3
    torch.testing.assert_close(fc[same], fm[same], rtol=1e-12, atol=0)
    torch.testing.assert_close(cc[same], cm[same], rtol=1e-10, atol=1e-12)


def test_audited_solve_reports_the_sweep_it_ran():
    """The audit's min SDF per scenario is the single-scenario cold sweep of
    the returned trajectory over the solve's points and the reserve pool."""
    conf, batch = _batch(B=3, integralIntervs=8, sweep_coarse_samples=16,
                         sweep_refine_rounds=4, safety_replan_rounds=1)
    shape = make_shape("Ball", conf)
    params = fl.FlatParams.from_config(conf)
    reserve = batch.points[:, :8] + 0.1
    coeffs, T, costs, iters, audit = pb.batched_solve_audited(
        shape, conf, batch, max_iters=4, chunk=4, audit_coarse_n=32,
        reserve_points=reserve, inject_budget=4, device="cpu")
    hist = audit["violations_per_round"]
    assert 1 <= len(hist) <= 2 and all(isinstance(v, int) for v in hist)
    assert audit["min_sdf"].shape == (3,) and costs.shape == (3,)
    for b in range(3):
        one = PolyTraj(T[b], coeffs[b])
        pts = torch.cat([batch.points[b], reserve[b]])
        sdf = sweep_sdf(shape, one, params, pts, coarse_n=32,
                        refine_rounds=4, device="cpu")[0]
        # the injected slots hold reserve points, so both sets are covered
        np.testing.assert_allclose(audit["min_sdf"][b], float(sdf.min()),
                                   rtol=1e-9, atol=1e-12)
    junc = pb._batched_junctions(coeffs, T)
    assert junc.shape == (3, 2, 3)
    torch.testing.assert_close(
        junc[1], PolyTraj(T[1], coeffs[1]).junction_positions()[1:-1])


def test_batch_entry_points_default_to_the_card(monkeypatch):
    conf, batch = _batch(B=2, P=4)
    shape = make_shape("Ball", conf)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: pb.make_random_batch(conf, 2),
        lambda: pb.batched_cost_and_grad(shape, conf, batch),
        lambda: pb.batched_solve(shape, conf, batch, max_iters=1),
        lambda: pb.batched_solve_chunked(shape, conf, batch, max_iters=1),
        lambda: pb.batched_solve_audited(shape, conf, batch, max_iters=1),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.slow
def test_chunked_solve_matches_jax_vmapped_solve():
    """The whole batched solve against JAX's vmapped one, float64: both run
    the same lockstep schedule on the same cost (f and g agree to 1e-10 at
    the start), so the accepted-step counts are equal.  The final costs
    agree to rtol 1e-3: measured, two of the four scenarios end within 1e-9
    and two within 2.7e-4 — the iterates drift apart by rounding, and a t*
    that lands on another candidate of the zoom changes the penalty by more
    than rounding.  (About two minutes, nearly all JAX compile.)"""
    jc = JConfig(**CONF)
    jb = jpb.make_random_batch(jc, 4, N=3, n_points=16, seed=0,
                               dtype=jnp.float64)
    cj, Tj, fj, ij = (np.asarray(a) for a in jpb.batched_solve_chunked(
        jmake_shape("Ball", jc), jc, jb, max_iters=8, chunk=4))
    conf, tb = _batch()
    ct, Tt, ft, it = pb.batched_solve_chunked(
        make_shape("Ball", conf), conf, tb, max_iters=8, chunk=4,
        device="cpu")
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_allclose(ft.numpy(), fj, rtol=1e-3)
    np.testing.assert_allclose(Tt.numpy(), Tj, rtol=1e-2)


@pytest.mark.slow
def test_stalled_line_search_matches_jax_at_bench_width():
    """At the bench's width (CappedCone, N = 4, P = 512, max_iters 24,
    chunk 8) scenarios 30, 106 and 124 of the seed-0 batch of 128 accept no
    step: the lockstep search's halve/double schedule has no bracket and
    cycles until max_ls.  Both packages must show it alike, float64: the same
    accepted-step counts (0, 0, 0 and 6 for scenario 0) and the same final
    costs to rtol 1e-6 (measured 1.4e-9), each stalled scenario ending at its
    refreshed baseline, just above its cold first cost.  (About three
    minutes, most of it JAX compile.)"""
    kw = dict(integralIntervs=32, sweep_coarse_samples=64,
              sweep_refine_rounds=12, vmax=5.0, omgmax=5.0, thetamax=1.5,
              safety_hor=0.4, mem_size=8)
    idx = np.array([30, 106, 124, 0])
    jc = JConfig(**kw)
    jb = jpb.make_random_batch(jc, 128, N=4, n_points=512, seed=0,
                               dtype=jnp.float64)
    fields = [np.asarray(getattr(jb, n))[idx] for n in FIELDS]
    jshape = jmake_shape("CappedCone", jc)
    jone = jpb.ScenarioBatch(*(jnp.asarray(a) for a in fields))
    f0j = np.asarray(jpb.batched_cost_and_grad(jshape, jc, jone)[0])
    _, _, fj, ij = (np.asarray(a) for a in jpb.batched_solve_chunked(
        jshape, jc, jone, max_iters=24, chunk=8))
    conf = Config(**kw)
    shape = make_shape("CappedCone", conf)
    one = pb.ScenarioBatch.from_arrays(*fields, device="cpu", dtype=F64)
    f0t, _ = pb.batched_cost_and_grad(shape, conf, one, device="cpu")
    _, _, ft, it = pb.batched_solve_chunked(shape, conf, one, max_iters=24,
                                            chunk=8, device="cpu")
    np.testing.assert_allclose(f0t.numpy(), f0j, rtol=1e-10)
    np.testing.assert_array_equal(it.numpy(), ij)
    assert ij[:3].tolist() == [0, 0, 0] and ij[3] > 0
    np.testing.assert_allclose(ft.numpy(), fj, rtol=1e-6)
    rise = ft.numpy()[:3] / f0j[:3] - 1.0
    assert np.all(rise > 0) and np.all(rise < 1e-4)
