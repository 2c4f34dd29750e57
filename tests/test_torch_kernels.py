"""K1, K2 and K4 on the card against their plain PyTorch versions.

This file imports neither JAX nor isdf_tpu, so it also runs where JAX is
not installed (tests/conftest.py imports JAX; leave it out there):

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Without a card the card tests skip; the wrappers' argument and build checks
run everywhere."""

import numpy as np
import pytest
import torch

from isdf_torch.config import Config
from isdf_torch.core import flatness as fl
from isdf_torch.core import minco
from isdf_torch.core.poly import PolyTraj
from isdf_torch.shapes import SHAPE_REGISTRY, make_shape
from isdf_torch.shapes.spec import KINDS
from isdf_torch.shapes.zoo import Shape
from isdf_torch.sweep import fused_zoom
from isdf_torch.sweep.sweep_sdf import traj_states

F32 = torch.float32
D_ATOL, D_RTOL, G_ATOL, T_AGREE = 2e-4, 1e-4, 1e-3, 1e-4
POSES = {"RoundedCone": (0.0, 0.0, 0.0, 120.0, 0.0, 0.0)}


def _inputs(name, dev, P=2048, N=5, coarse_n=64, seed=0):
    rng = np.random.default_rng(seed)
    q = (np.linspace(1, 8, N - 1)[:, None] * np.array([1.0, 0.3, 0.15])
         + rng.normal(scale=0.3, size=(N - 1, 3)))
    T = torch.as_tensor(rng.uniform(1.2, 2.2, size=N), dtype=F32, device=dev)
    tail = torch.zeros(3, 3, dtype=F32, device=dev)
    tail[:, 0] = torch.tensor([9.0, 2.5, 1.2])
    traj = PolyTraj(T, minco.solve(torch.as_tensor(q, dtype=F32, device=dev),
                                   T, torch.zeros_like(tail), tail))
    conf = Config(poly_params=POSES.get(name, (0.0,) * 6))
    shape, params = make_shape(name, conf), fl.FlatParams.from_config(conf)
    pts = torch.as_tensor(rng.uniform(-1, 10, size=(P, 3)), dtype=F32,
                          device=dev)
    tw = torch.as_tensor(rng.uniform(0, float(T.sum()), size=P), dtype=F32,
                         device=dev)
    ts = torch.linspace(0.0, 1.0, coarse_n, dtype=F32, device=dev)
    xs, Rs = traj_states(traj, params, ts * traj.total_duration)
    pose = torch.cat([xs, Rs.reshape(-1, 9)], dim=1).contiguous()
    starts = (torch.cumsum(T, 0) - T).contiguous()
    return shape, params, (pts, tw, pose, starts, T.contiguous(),
                           traj.coeffs.contiguous())


def test_wrapper_rejects_malformed_inputs():
    shape, params, args = _inputs("Ball", "cpu", P=16)
    with pytest.raises(ValueError, match="multiple of k"):
        fused_zoom.sweep_warm_fused(shape, params, *args, coarse_n=60)
    with pytest.raises(ValueError, match="k = 8"):
        fused_zoom.sweep_warm_fused(shape, params, *args, k=4)
    pts, tw, *rest = args
    with pytest.raises(ValueError, match="expected"):
        fused_zoom.sweep_warm_fused(shape, params, pts[:, :2], tw, *rest)
    before = fused_zoom.LAUNCHES
    t, d, g = fused_zoom.sweep_warm_fused(shape, params, *args)
    assert fused_zoom.LAUNCHES == before            # CPU: the plain version
    assert t.shape == d.shape == (16,) and g.shape == (16, 3)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(fused_zoom.shutil, "which", lambda name: None)
    monkeypatch.setattr(fused_zoom.os.path, "exists", lambda p: False)
    monkeypatch.setattr(fused_zoom, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        fused_zoom.build()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["RoundedCone", "Ball", "CappedCone"])
def test_kernel_matches_plain_version_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python3 chip_smoke.py runs K1 too)")
    shape, params, args = _inputs(name, torch.device("cuda"))
    before = fused_zoom.LAUNCHES
    tk, dk, gk = fused_zoom.sweep_warm_fused(shape, params, *args,
                                             coarse_n=64, rounds=12)
    assert fused_zoom.LAUNCHES == before + 1
    tr, dr, gr = fused_zoom.sweep_warm_fused_ref(shape, params, *args,
                                                 coarse_n=64, rounds=12)
    torch.cuda.synchronize()
    assert torch.all((dk - dr).abs() <= D_ATOL + D_RTOL * dr.abs())
    ok = (tk - tr).abs() < T_AGREE
    assert float(ok.float().mean()) >= 0.99
    assert float((gk - gr).abs()[ok].max()) <= G_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("coarse_n", [256, 2048])
@pytest.mark.parametrize("name", ["RoundedCone", "Ball", "CappedCone"])
def test_audit_sweep_matches_plain_version_on_card(name, coarse_n):
    """The audit's cold sweep: t_warm = 0, window 0.3, rounds 24, and a pose
    table of up to 2048 rows (96 KB, read from global memory)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python3 chip_smoke.py runs K1 too)")
    shape, params, (pts, tw, *rest) = _inputs(name, torch.device("cuda"),
                                              coarse_n=coarse_n)
    args = (pts, torch.zeros_like(tw), *rest)
    kw = dict(coarse_n=coarse_n, rounds=24, warm_window=0.3)
    tk, dk, gk = fused_zoom.sweep_warm_fused(shape, params, *args, **kw)
    tr, dr, gr = fused_zoom.sweep_warm_fused_ref(shape, params, *args, **kw)
    torch.cuda.synchronize()
    assert torch.all((dk - dr).abs() <= D_ATOL + D_RTOL * dr.abs())
    ok = (tk - tr).abs() < T_AGREE
    assert float(ok.float().mean()) >= 0.99
    assert float((gk - gr).abs()[ok].max()) <= G_ATOL


@pytest.mark.cuda
def test_shape_without_device_sdf_raises_on_card():
    """Every zoo shape has a device SDF; a shape built by hand without a
    spec cannot run on the card and must say so, not drop to the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, params, args = _inputs("Ball", torch.device("cuda"), P=256)
    ball = make_shape("Ball")
    bare = Shape("HandBuilt", ball.sdf, ball.bounds, sdf3=ball.sdf3)
    with pytest.raises(NotImplementedError, match="HandBuilt"):
        fused_zoom.sweep_warm_fused(bare, params, *args)
    with pytest.raises(NotImplementedError, match="HandBuilt"):
        fused_zoom.zoom_refine(bare, params, args[0], args[1],
                               torch.full_like(args[1], 0.3), *args[3:])


def test_batched_wrapper_rejects_malformed_inputs():
    shape, params, args = _inputs("Ball", "cpu", P=16)
    batched = tuple(torch.stack([a, a]) for a in args)
    with pytest.raises(ValueError, match=r"expected \(B, P, 3\)"):
        fused_zoom.sweep_warm_fused_batched(shape, params, *args)
    with pytest.raises(ValueError, match=r"expected \(P, 3\)"):
        fused_zoom.sweep_warm_fused(shape, params, *batched)
    pts, tw, pose, *rest = batched
    with pytest.raises(ValueError, match="pose table"):
        fused_zoom.sweep_warm_fused_batched(shape, params, pts, tw, pose[0],
                                            *rest)
    with pytest.raises(ValueError, match="piece count"):
        fused_zoom.sweep_warm_fused_batched(shape, params, pts, tw, pose,
                                            rest[0][:1], *rest[1:])
    t, d, g = fused_zoom.sweep_warm_fused_batched(shape, params, *batched)
    assert t.shape == d.shape == (2, 16) and g.shape == (2, 16, 3)
    assert torch.equal(t[0], t[1])


def test_build_starts_one_compile_per_kind(monkeypatch, tmp_path):
    """Every kind is compiled from the one source with its own -DSDF_KIND,
    all processes started before any is waited for; a failed compile
    raises with the compiler's message and leaves no library behind."""
    started = []

    class FakeProc:
        def __init__(self, cmd, **kw):
            self.cmd, self.returncode = cmd, None
            started.append(self)

        def communicate(self):
            assert len(started) == len(KINDS)     # all started together
            kind = next(a for a in self.cmd if a.startswith("-DSDF_KIND="))
            self.returncode = 1 if kind == "-DSDF_KIND=7" else 0
            return "", "boom in kind 7"

        def poll(self):
            return self.returncode

    monkeypatch.setattr(fused_zoom, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(fused_zoom, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(fused_zoom.subprocess, "Popen", FakeProc)
    with pytest.raises(RuntimeError, match="boom in kind 7"):
        fused_zoom.build()
    defines = sorted(a for p in started for a in p.cmd if a.startswith("-D"))
    assert defines == sorted(f"-DSDF_KIND={k}" for k in KINDS)
    assert all(str(fused_zoom.SOURCE) in p.cmd for p in started)
    built = sorted(f.name for f in tmp_path.iterdir())
    assert len(built) == len(KINDS) - 1 and not any("_k7_" in n for n in built)
    assert {make_shape(n).spec.kind for n in SHAPE_REGISTRY} == set(KINDS)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SHAPE_REGISTRY))
def test_every_zoo_shape_runs_on_card(name):
    """K1 launches for each of the 20 shapes and agrees with its plain
    version in the bands."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python3 chip_smoke.py runs K1 too)")
    shape, params, args = _inputs(name, torch.device("cuda"))
    tk, dk, gk = fused_zoom.sweep_warm_fused(shape, params, *args,
                                             coarse_n=64, rounds=12)
    tr, dr, gr = fused_zoom.sweep_warm_fused_ref(shape, params, *args,
                                                 coarse_n=64, rounds=12)
    torch.cuda.synchronize()
    assert torch.all((dk - dr).abs() <= D_ATOL + D_RTOL * dr.abs())
    ok = (tk - tr).abs() < T_AGREE
    assert float(ok.float().mean()) >= 0.99
    assert float((gk - gr).abs()[ok].max()) <= G_ATOL


def _batched_inputs(name, dev, B=8, P=512):
    per = [_inputs(name, dev, P=P, N=4, seed=10 + b) for b in range(B)]
    shape, params, _ = per[0]
    return shape, params, per, tuple(
        torch.stack([p[2][i] for p in per]).contiguous() for i in range(6))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["CappedCone", "CSG", "Trefoil"])
def test_batched_kernel_matches_per_scenario_launches_on_card(name):
    """K2 in one launch against K1 launched per scenario (exact: the same
    device code on the same inputs) and against its plain version (bands)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python3 chip_smoke.py runs K2 too)")
    shape, params, per, args = _batched_inputs(name, torch.device("cuda"))
    before = fused_zoom.LAUNCHES_BATCHED, fused_zoom.LAUNCHES
    tk, dk, gk = fused_zoom.sweep_warm_fused_batched(shape, params, *args)
    assert fused_zoom.LAUNCHES_BATCHED == before[0] + 1
    assert fused_zoom.LAUNCHES == before[1]
    tr, dr, gr = fused_zoom.sweep_warm_fused_batched_ref(shape, params, *args)
    for b, (_, _, a1) in enumerate(per):
        t1, d1, g1 = fused_zoom.sweep_warm_fused(shape, params, *a1)
        assert torch.equal(tk[b], t1) and torch.equal(dk[b], d1)
        assert torch.equal(gk[b], g1)
    torch.cuda.synchronize()
    assert torch.all((dk - dr).abs() <= D_ATOL + D_RTOL * dr.abs())
    ok = (tk - tr).abs() < T_AGREE
    assert float(ok.float().mean()) >= 0.99
    assert float((gk - gr).abs()[ok].max()) <= G_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["CappedCone", "CSG", "Trefoil"])
def test_zoom_kernel_matches_plain_version_on_card(name):
    """K4: t* within 1e-4 of the plain version's on ≥ 99 % of the points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python3 chip_smoke.py runs K4 too)")
    shape, params, (pts, tw, _, starts, durs, coeffs) = _inputs(
        name, torch.device("cuda"))
    w0 = torch.full_like(tw, 0.3)
    before = fused_zoom.LAUNCHES_ZOOM
    tk = fused_zoom.zoom_refine(shape, params, pts, tw, w0, starts, durs,
                                coeffs)
    assert fused_zoom.LAUNCHES_ZOOM == before + 1
    tr = fused_zoom.zoom_refine_ref(shape, params, pts, tw, w0, starts, durs,
                                    coeffs)
    torch.cuda.synchronize()
    assert float(((tk - tr).abs() < T_AGREE).float().mean()) >= 0.99
