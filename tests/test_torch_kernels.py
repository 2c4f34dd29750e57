"""K1, K2, K3 and K4 on the card against their plain PyTorch versions.

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
from isdf_torch.sweep import fused_zoom, grid_zoom
from isdf_torch.shapes.gridsdf import grid_shape
from isdf_torch.sweep.sweep_sdf import sweep_sdf, sweep_sdf_warm, traj_states

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


# ---------------------------------------------------------------------------
# K3, the grid (mesh robot) sweep

def _grid_inputs(dev, P=2048, N=5, seed=0, n=40, res=0.06):
    """A torus field (ring 0.6, tube 0.25) of n³ voxels centred on the
    origin, and K1's trajectory and points without the pose table."""
    origin = -0.5 * (n - 1) * res
    ax = origin + np.arange(n) * res
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    field = np.sqrt((np.sqrt(x * x + y * y) - 0.6) ** 2 + z * z) - 0.25
    grid = grid_zoom.GridField.build(field, (origin,) * 3, res, dev)
    _, params, (pts, tw, _, starts, durs, coeffs) = _inputs(
        "Ball", dev, P=P, N=N, seed=seed)
    return grid, params, (pts, tw, starts, durs, coeffs)


def test_grid_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(fused_zoom.shutil, "which", lambda name: None)
    monkeypatch.setattr(fused_zoom.os.path, "exists", lambda p: False)
    monkeypatch.setattr(fused_zoom, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        grid_zoom.build()


def test_grid_kernel_builds_beside_the_others(monkeypatch, tmp_path):
    """K3's library is one more job of the same parallel build: one nvcc
    process for grid_sweep.cu with no defines, started with the kinds'."""
    started = []

    class FakeProc:
        def __init__(self, cmd, **kw):
            self.cmd, self.returncode = cmd, None
            started.append(self)

        def communicate(self):
            assert len(started) == len(KINDS) + 1
            self.returncode = 0
            return "", ""

        def poll(self):
            return self.returncode

    monkeypatch.setattr(fused_zoom, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(fused_zoom, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(fused_zoom.subprocess, "Popen", FakeProc)
    libs = fused_zoom.compile_jobs(fused_zoom.build_jobs()
                                   + grid_zoom.build_jobs())
    k3 = [p for p in started if str(grid_zoom.SOURCE) in p.cmd]
    assert len(k3) == 1
    assert not any(a.startswith("-D") for a in k3[0].cmd)
    assert libs["K3"].exists() and libs["K3"].parent == tmp_path


@pytest.mark.cuda
@pytest.mark.parametrize("coarse_n,cold", [(64, False), (256, True),
                                           (2048, True)])
def test_grid_kernel_matches_plain_version_on_card(coarse_n, cold):
    """K3 warm (coarse 64, rounds 12) and as the audit runs it (t_warm = 0,
    window 0.3, rounds 24) against grid_sweep_warm_fused_ref: d* within
    2e-4 + 1e-4·|d|, t* within 1e-4 on ≥ 99 % of the points, the gradient
    within 1e-3 there; one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python3 chip_smoke.py runs K3 too)")
    grid, params, (pts, tw, *rest) = _grid_inputs(torch.device("cuda"))
    args = (pts, torch.zeros_like(tw) if cold else tw, *rest)
    kw = dict(coarse_n=coarse_n, rounds=24 if cold else 12, warm_window=0.3)
    before = grid_zoom.LAUNCHES_GRID
    tk, dk, gk = grid_zoom.grid_sweep_warm_fused(grid, params, *args, **kw)
    assert grid_zoom.LAUNCHES_GRID == before + 1
    tr, dr, gr = grid_zoom.grid_sweep_warm_fused_ref(grid, params, *args,
                                                     **kw)
    torch.cuda.synchronize()
    assert torch.all((dk - dr).abs() <= D_ATOL + D_RTOL * dr.abs())
    ok = (tk - tr).abs() < T_AGREE
    assert float(ok.float().mean()) >= 0.99
    assert float((gk - gr).abs()[ok].max()) <= G_ATOL


@pytest.mark.cuda
def test_grid_batched_kernel_matches_per_scenario_launches_on_card():
    """K3 over B = 8 scenarios in one launch against K3 launched per
    scenario (exact: the same device code on the same inputs) and against
    its plain version (the bands above)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python3 chip_smoke.py runs K3 too)")
    dev = torch.device("cuda")
    per = [_grid_inputs(dev, P=512, N=4, seed=10 + b) for b in range(8)]
    grid, params, _ = per[0]
    args = tuple(torch.stack([p[2][i] for p in per]).contiguous()
                 for i in range(5))
    before = grid_zoom.LAUNCHES_GRID
    tk, dk, gk = grid_zoom.grid_sweep_warm_fused_batched(grid, params, *args)
    assert grid_zoom.LAUNCHES_GRID == before + 1
    for b, (_, _, a1) in enumerate(per):
        t1, d1, g1 = grid_zoom.grid_sweep_warm_fused(grid, params, *a1)
        assert torch.equal(tk[b], t1) and torch.equal(dk[b], d1)
        assert torch.equal(gk[b], g1)
    tr, dr, gr = grid_zoom.grid_sweep_warm_fused_batched_ref(grid, params,
                                                             *args)
    torch.cuda.synchronize()
    assert torch.all((dk - dr).abs() <= D_ATOL + D_RTOL * dr.abs())
    ok = (tk - tr).abs() < T_AGREE
    assert float(ok.float().mean()) >= 0.99
    assert float((gk - gr).abs()[ok].max()) <= G_ATOL


@pytest.mark.cuda
def test_grid_branches_launch_the_kernel_on_card(monkeypatch):
    """A grid shape's warm and cold sweeps on CUDA tensors launch K3 once
    each and never run its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python3 chip_smoke.py runs K3 too)")
    dev = torch.device("cuda")
    grid, params, (pts, tw, _, durs, coeffs) = _grid_inputs(dev, P=256)
    shape = grid_shape("torus", grid.field, grid.origin, grid.res,
                       device=dev)
    traj = PolyTraj(durs, coeffs)

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(grid_zoom, "grid_sweep_warm_fused_ref", refuse)
    before = grid_zoom.LAUNCHES_GRID
    s, t, g = sweep_sdf_warm(shape, traj, params, pts, tw)
    sc, tc, gc = sweep_sdf(shape, traj, params, pts)
    torch.cuda.synchronize()
    assert grid_zoom.LAUNCHES_GRID == before + 2
    for a in (s, t, g, sc, tc, gc):
        assert a.is_cuda and bool(torch.isfinite(a).all())
