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
    built = sorted(f.name for f in tmp_path.iterdir() if f.suffix == ".so")
    assert len(built) == len(KINDS) - 1 and not any("_k7_" in n for n in built)
    assert not any("_k7_" in f.name for f in tmp_path.iterdir())
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


# ---------------------------------------------------------------------------
# the lanes of a point, the shared-memory tables and the ragged edge

@pytest.mark.parametrize("B,P,lanes", [
    (1, 1, fused_zoom.SWEEP_LANES),
    (1, 4096, fused_zoom.SWEEP_LANES),
    (1, fused_zoom.LANES_MAX_POINTS, fused_zoom.SWEEP_LANES),
    (1, fused_zoom.LANES_MAX_POINTS + 1, 1),
    (fused_zoom.LANES_MAX_POINTS // 512, 512, fused_zoom.SWEEP_LANES),
    (fused_zoom.LANES_MAX_POINTS // 512 + 1, 512, 1),
    (4096, 512, 1),
])
def test_lanes_follow_the_launch_size(B, P, lanes):
    """K1/K2 give a point SWEEP_LANES threads up to LANES_MAX_POINTS points
    in the launch, one beyond; the rule reads B·P alone."""
    assert fused_zoom._lanes_for(B, P) == lanes
    assert fused_zoom._lanes_for(P, B) == lanes


def test_block_count_limit():
    """The one-dimensional grid holds 2^31 − 1 blocks; eight lanes a point
    need eight times the blocks."""
    B = 2 ** 24 - 1
    fused_zoom.check_blocks(B, 16384, 1)           # 2^31 − 128 blocks
    fused_zoom.check_blocks(B, 2048, 8)
    with pytest.raises(ValueError, match="split the batch"):
        fused_zoom.check_blocks(B, 16384 + 1, 1)
    with pytest.raises(ValueError, match="split the batch"):
        fused_zoom.check_blocks(B, 16384, 8)


def test_wrappers_reject_tables_past_shared_memory():
    """The pose table and the piece tables of a scenario must fit one
    block's shared memory: every sweep wrapper refuses a coarse_n past it,
    on any device."""
    N = 5
    fit = (fused_zoom.SMEM_MAX // 4 - fused_zoom.TABLE_FLOATS * N) // 12
    fit -= fit % 8
    assert fused_zoom.sweep_smem_bytes(N, fit) <= fused_zoom.SMEM_MAX
    assert fused_zoom.sweep_smem_bytes(N, fit + 8) > fused_zoom.SMEM_MAX
    assert fit >= 2048                   # the audit's cap fits
    shape, params, (pts, tw, _, starts, durs, coeffs) = _inputs(
        "Ball", "cpu", P=8, N=N)
    pose = torch.zeros(fit + 8, 12)
    with pytest.raises(ValueError, match="shared memory"):
        fused_zoom.sweep_warm_fused(shape, params, pts, tw, pose, starts,
                                    durs, coeffs, coarse_n=fit + 8)
    grid, gparams, gargs = _grid_inputs("cpu", P=8, N=N)
    with pytest.raises(ValueError, match="shared memory"):
        grid_zoom.grid_sweep_warm_fused(grid, gparams, *gargs,
                                        coarse_n=fit + 8)


PTXAS_SAMPLE = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z17sweep_warm_kernelILi3ELi8EEvPKfS1_S1_S1_S1_S1_PfS2_S2_iiiifi9ShapeSpec8FlatArgs' for 'sm_90a'
ptxas info    : Function properties for _Z17sweep_warm_kernelILi3ELi8EEvPKfS1_S1_S1_S1_S1_PfS2_S2_iiiifi9ShapeSpec8FlatArgs
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 536 bytes cmem[0]
ptxas info    : Compiling entry function '_Z17grid_sweep_kernelILi4EEvPKfS1_S1_S1_S1_PfS2_S2_iiiiff9GridFieldS3_8FlatArgsi' for 'sm_90a'
ptxas info    : Function properties for _Z17grid_sweep_kernelILi4EEvPKfS1_S1_S1_S1_PfS2_S2_iiiiff9GridFieldS3_8FlatArgsi
    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 500 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_and_spills(tmp_path):
    lib = tmp_path / "sweep_warm_k3_0123.so"
    assert fused_zoom.ptxas_report(lib) == []           # nothing built
    (tmp_path / "sweep_warm_k3_0123.ptxas.txt").write_text(PTXAS_SAMPLE)
    assert fused_zoom.ptxas_report(lib) == [
        ("sweep_warm_kernel<3,8>", 72, 0, 0, 0),
        ("grid_sweep_kernel<4>", 255, 8, 12, 16)]


def test_build_keeps_what_ptxas_says(monkeypatch, tmp_path):
    """A successful compile writes the compiler's report beside the
    library; the build asks ptxas for it."""

    class FakeProc:
        def __init__(self, cmd, **kw):
            self.cmd, self.returncode = cmd, None

        def communicate(self):
            self.returncode = 0
            return "", PTXAS_SAMPLE

        def poll(self):
            return self.returncode

    monkeypatch.setattr(fused_zoom, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(fused_zoom, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(fused_zoom.subprocess, "Popen", FakeProc)
    assert "-v" in fused_zoom.NVCC_FLAGS
    lib = grid_zoom.build()
    assert fused_zoom.ptxas_report(lib)[1][0] == "grid_sweep_kernel<4>"


def _hover_inputs(name, dev, P=1024, coarse_n=64, seed=5):
    """K1's inputs on a three-piece trajectory whose middle piece hovers
    (zero velocity and acceleration): every coarse row in it has the same
    pose, so the coarse scan meets exact ties, and so do the zoom's
    candidates there."""
    shape, params, (pts, tw, _, starts, durs, coeffs) = _inputs(
        name, dev, P=P, N=3, coarse_n=coarse_n, seed=seed)
    coeffs = coeffs.clone()
    hover = torch.tensor([4.0, 1.2, 0.6], dtype=F32, device=dev)
    coeffs[1] = 0.0
    coeffs[1, 0] = hover
    traj = PolyTraj(durs, coeffs)
    ts = torch.linspace(0.0, 1.0, coarse_n, dtype=F32, device=dev)
    xs, Rs = traj_states(traj, params, ts * traj.total_duration)
    pose = torch.cat([xs, Rs.reshape(-1, 9)], dim=1).contiguous()
    rng = np.random.default_rng(seed)
    near = torch.as_tensor(rng.uniform(-1.0, 1.0, size=(P, 3)), dtype=F32,
                           device=dev) + hover
    return shape, params, (near.contiguous(), tw, pose, starts, durs,
                           coeffs.contiguous())


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python3 chip_smoke.py runs the "
                    "kernels too)")
    return torch.device("cuda")


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_hover_ties_bitwise_on_card():
    """(a) A hovering piece: many coarse rows tie exactly.  K1, K2 and K3
    split the rows over a point's lanes and must still take the first
    minimum in (row, group) order: t* and d* (K3: and the gradient) bitwise
    equal to the plain versions, K2 also to per-scenario K1."""
    dev = _cuda()
    shape, params, args = _hover_inputs("CappedCone", dev)
    tk, dk, gk = fused_zoom.sweep_warm_fused(shape, params, *args)
    tr, dr, gr = fused_zoom.sweep_warm_fused_ref(shape, params, *args)
    assert _same((tk, dk), (tr, dr))
    assert float((gk - gr).abs().max()) <= G_ATOL
    per = [_hover_inputs("CappedCone", dev, seed=5 + b)[2] for b in range(4)]
    batched = tuple(torch.stack([a[i] for a in per]).contiguous()
                    for i in range(6))
    t2, d2, g2 = fused_zoom.sweep_warm_fused_batched(shape, params, *batched)
    for b, a in enumerate(per):
        assert _same((t2[b], d2[b], g2[b]),
                     fused_zoom.sweep_warm_fused(shape, params, *a))
    tr2, dr2, _ = fused_zoom.sweep_warm_fused_batched_ref(shape, params,
                                                          *batched)
    assert _same((t2, d2), (tr2, dr2))
    grid, gparams, _ = _grid_inputs(dev, P=8)
    pts, tw, _, starts, durs, coeffs = args
    gargs = (pts, tw, starts, durs, coeffs)
    got = grid_zoom.grid_sweep_warm_fused(grid, gparams, *gargs)
    want = grid_zoom.grid_sweep_warm_fused_ref(grid, gparams, *gargs)
    assert _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4"])
def test_ragged_edge_bitwise_on_card(kernel):
    """(b) P = 4093, a multiple of neither the block nor the lanes: the
    lanes of the points past P take part in every shuffle and store
    nothing; every point's result bitwise equal to the plain version's."""
    dev = _cuda()
    P = 4093
    if kernel == "K3":
        grid, params, args = _grid_inputs(dev, P=P)
        got = grid_zoom.grid_sweep_warm_fused(grid, params, *args)
        want = grid_zoom.grid_sweep_warm_fused_ref(grid, params, *args)
        assert _same(got, want)
        return
    shape, params, args = _inputs("RoundedCone", dev, P=P)
    if kernel == "K4":
        pts, tw, _, starts, durs, coeffs = args
        w0 = torch.full_like(tw, 0.3)
        got = fused_zoom.zoom_refine(shape, params, pts, tw, w0, starts, durs,
                                     coeffs)
        want = fused_zoom.zoom_refine_ref(shape, params, pts, tw, w0, starts,
                                          durs, coeffs)
        assert torch.equal(got, want)
        return
    if kernel == "K2":
        args = tuple(torch.stack([a, a]).contiguous() for a in args)
        tk, dk, gk = fused_zoom.sweep_warm_fused_batched(shape, params, *args)
        tr, dr, gr = fused_zoom.sweep_warm_fused_batched_ref(shape, params,
                                                             *args)
    else:
        tk, dk, gk = fused_zoom.sweep_warm_fused(shape, params, *args)
        tr, dr, gr = fused_zoom.sweep_warm_fused_ref(shape, params, *args)
    assert _same((tk, dk), (tr, dr))
    assert float((gk - gr).abs().max()) <= G_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("above", [False, True])
def test_batched_lanes_threshold_bitwise_on_card(above, monkeypatch):
    """(c) K2 at the largest launch that takes sixteen lanes a point and at
    the next larger one, which takes one: each bitwise equal to K1 launched
    per scenario and, on five scenarios, to the plain
    version; and the same inputs through every lane count the kernel
    takes, forced, give the same bits."""
    dev = _cuda()
    P = 512
    B = fused_zoom.LANES_MAX_POINTS // P + int(above)
    assert fused_zoom._lanes_for(B, P) == (
        1 if above else fused_zoom.SWEEP_LANES)
    per = [_inputs("CappedCone", dev, P=P, N=4, seed=100 + b)
           for b in range(B)]
    shape, params, _ = per[0]
    args = tuple(torch.stack([p[2][i] for p in per]).contiguous()
                 for i in range(6))
    got = fused_zoom.sweep_warm_fused_batched(shape, params, *args)
    for b in range(B):
        assert _same((g[b] for g in got),
                     fused_zoom.sweep_warm_fused(shape, params, *per[b][2]))
    rows = [0, B // 3, B // 2, 2 * B // 3, B - 1]
    for b in rows:
        tr, dr, _ = fused_zoom.sweep_warm_fused_ref(shape, params,
                                                    *per[b][2])
        assert _same((got[0][b], got[1][b]), (tr, dr))
    for lanes in (1, fused_zoom.SWEEP_LANES):
        monkeypatch.setattr(fused_zoom, "_lanes_for", lambda B, P: lanes)
        assert _same(got, fused_zoom.sweep_warm_fused_batched(shape, params,
                                                              *args))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K3"])
def test_pose_table_past_48kb_bitwise_on_card(kernel):
    """(d) coarse_n = 2048, the audit's cap: the pose table (96 KB) and the
    piece tables in one block's dynamic shared memory, past the 48 KB
    default; cold sweep, rounds 24, bitwise equal to the plain version
    (K1: t*, d*; K3: t*, d*, gradient)."""
    dev = _cuda()
    kw = dict(coarse_n=2048, rounds=24, warm_window=0.3)
    assert fused_zoom.sweep_smem_bytes(5, 2048) > 48 * 1024
    if kernel == "K3":
        grid, params, (pts, tw, *rest) = _grid_inputs(dev)
        args = (pts, torch.zeros_like(tw), *rest)
        assert _same(grid_zoom.grid_sweep_warm_fused(grid, params, *args,
                                                     **kw),
                     grid_zoom.grid_sweep_warm_fused_ref(grid, params, *args,
                                                         **kw))
        return
    shape, params, (pts, tw, *rest) = _inputs("CappedCone", dev,
                                              coarse_n=2048)
    args = (pts, torch.zeros_like(tw), *rest)
    tk, dk, gk = fused_zoom.sweep_warm_fused(shape, params, *args, **kw)
    tr, dr, gr = fused_zoom.sweep_warm_fused_ref(shape, params, *args, **kw)
    assert _same((tk, dk), (tr, dr))
    assert float((gk - gr).abs().max()) <= G_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("coarse_n", [8, 16])
def test_small_pose_table_bitwise_on_card(coarse_n):
    """coarse_n = 8 is one group of pose rows, so the last eight of a
    point's sixteen lanes scan no row: they must not win the lanes'
    combine.  K1 and K2 at coarse_n = 8 and 16, warm and cold: t* and d*
    bitwise equal to the plain versions, K2 also to per-scenario K1."""
    dev = _cuda()
    for cold in (False, True):
        kw = dict(coarse_n=coarse_n, rounds=12)
        per = []
        for b in range(4):
            shape, params, (pts, tw, *rest) = _inputs(
                "CappedCone", dev, P=512, coarse_n=coarse_n, seed=20 + b)
            per.append((pts, torch.zeros_like(tw) if cold else tw, *rest))
        assert fused_zoom._lanes_for(4, 512) == fused_zoom.SWEEP_LANES
        for a in per:
            tk, dk, gk = fused_zoom.sweep_warm_fused(shape, params, *a, **kw)
            tr, dr, gr = fused_zoom.sweep_warm_fused_ref(shape, params, *a,
                                                         **kw)
            assert _same((tk, dk), (tr, dr))
            assert float((gk - gr).abs().max()) <= G_ATOL
        batched = tuple(torch.stack([a[i] for a in per]).contiguous()
                        for i in range(6))
        got = fused_zoom.sweep_warm_fused_batched(shape, params, *batched,
                                                  **kw)
        for b, a in enumerate(per):
            assert _same((g[b] for g in got),
                         fused_zoom.sweep_warm_fused(shape, params, *a, **kw))
        tr2, dr2, _ = fused_zoom.sweep_warm_fused_batched_ref(
            shape, params, *batched, **kw)
        assert _same(got[:2], (tr2, dr2))


# ---------------------------------------------------------------------------
# the planar (SE(2)) pose map: the third trajectory axis is the yaw

PLANAR_CONF = {"Box": dict(box_x=1.4, box_y=0.2, box_z=0.2), "Ball": {}}


def _planar_inputs(name, dev, P=2048, N=6, coarse_n=64, seed=20):
    """A planar (x, y, ψ) trajectory through a field of obstacle points in
    the plane z = 0, the yaw turning by ~1.5 rad, and the pose table under
    PlanarPose."""
    rng = np.random.default_rng(seed)
    u = np.linspace(0, 1, N + 1)[1:-1, None]
    q = (np.array([2.0, 2.0, 0.0]) + u * np.array([10.0, 8.0, 1.5])
         + rng.normal(scale=[0.4, 0.4, 0.2], size=(N - 1, 3)))
    T = torch.as_tensor(rng.uniform(1.2, 2.2, size=N), dtype=F32, device=dev)
    head = torch.zeros(3, 3, dtype=F32, device=dev)
    head[:, 0] = torch.tensor([2.0, 2.0, 0.0])
    tail = torch.zeros(3, 3, dtype=F32, device=dev)
    tail[:, 0] = torch.tensor([12.0, 10.0, 1.5])
    traj = PolyTraj(T, minco.solve(torch.as_tensor(q, dtype=F32, device=dev),
                                   T, head, tail))
    shape = make_shape(name, Config(**PLANAR_CONF[name]))
    params = fl.PlanarPose(0.0)
    xy = (np.linspace([2.0, 2.0], [12.0, 10.0], P)
          + rng.uniform(-2.0, 2.0, size=(P, 2)))
    pts = torch.as_tensor(np.concatenate([xy, np.zeros((P, 1))], axis=1),
                          dtype=F32, device=dev)
    tw = torch.as_tensor(rng.uniform(0, float(T.sum()), size=P), dtype=F32,
                         device=dev)
    ts = torch.linspace(0.0, 1.0, coarse_n, dtype=F32, device=dev)
    xs, Rs = traj_states(traj, params, ts * traj.total_duration)
    pose = torch.cat([xs, Rs.reshape(-1, 9)], dim=1).contiguous()
    starts = (torch.cumsum(T, 0) - T).contiguous()
    return shape, params, (pts, tw, pose, starts, T.contiguous(),
                           traj.coeffs.contiguous())


def test_wrappers_reject_other_pose_maps():
    shape, _, args = _planar_inputs("Box", "cpu", P=8)
    with pytest.raises(TypeError, match="pose map"):
        fused_zoom.sweep_warm_fused(shape, object(), *args)
    with pytest.raises(TypeError, match="pose map"):
        fused_zoom.sweep_warm_fused_batched(
            shape, None, *(a[None] for a in args))
    pts, tw, _, starts, durs, coeffs = args
    with pytest.raises(TypeError, match="pose map"):
        fused_zoom.zoom_refine(shape, "planar", pts, tw,
                               torch.full_like(tw, 0.3), starts, durs, coeffs)
    grid, _, gargs = _grid_inputs("cpu", P=8)
    with pytest.raises(TypeError, match="pose map"):
        grid_zoom.grid_sweep_warm_fused(grid, {"z_ref": 0.0}, *gargs)


def test_pose_map_reaches_the_c_struct():
    flat = fused_zoom.pose_args_c(fl.FlatParams(mass=0.5, dh=0.2))
    assert flat.planar == 0
    assert flat.kd == pytest.approx(0.4) and flat.grav == pytest.approx(9.8)
    planar = fused_zoom.pose_args_c(fl.PlanarPose(z_ref=0.75))
    assert planar.planar == 1 and planar.z_ref == 0.75


def test_ptxas_report_names_the_pose_map(tmp_path):
    """Each kernel is instantiated for both pose maps; the report tells the
    two apart by the map's struct."""
    lib = tmp_path / "sweep_warm_k15_0123.so"
    (tmp_path / "sweep_warm_k15_0123.ptxas.txt").write_text(
        PTXAS_SAMPLE.replace("ILi3ELi8EE", "ILi15ELi16E10PlanarArgsE")
        .replace("ILi4EE", "ILi4E8FlatArgsE"))
    assert fused_zoom.ptxas_report(lib) == [
        ("sweep_warm_kernel<15,16,PlanarArgs>", 72, 0, 0, 0),
        ("grid_sweep_kernel<4,FlatArgs>", 255, 8, 12, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("cold", [False, True])
@pytest.mark.parametrize("name,coarse_n", [("Box", 64), ("Ball", 48)])
def test_planar_kernel_matches_plain_version_on_card(name, coarse_n, cold):
    """K1 under PlanarPose (demo 8's bar, demo 7's disc robot): t* and d*
    bitwise equal to the plain version's, the gradient in its band."""
    dev = _cuda()
    shape, params, (pts, tw, *rest) = _planar_inputs(name, dev,
                                                     coarse_n=coarse_n)
    args = (pts, torch.zeros_like(tw) if cold else tw, *rest)
    kw = dict(coarse_n=coarse_n, rounds=8)
    before = fused_zoom.LAUNCHES
    tk, dk, gk = fused_zoom.sweep_warm_fused(shape, params, *args, **kw)
    assert fused_zoom.LAUNCHES == before + 1
    tr, dr, gr = fused_zoom.sweep_warm_fused_ref(shape, params, *args, **kw)
    torch.cuda.synchronize()
    assert _same((tk, dk), (tr, dr))
    assert float((gk - gr).abs().max()) <= G_ATOL


@pytest.mark.cuda
def test_planar_lanes_bitwise_on_card(monkeypatch):
    """The one- and 16-lane launches of K1 under PlanarPose agree bit for
    bit."""
    dev = _cuda()
    shape, params, args = _planar_inputs("Box", dev)
    assert fused_zoom._lanes_for(1, args[0].shape[0]) == 16
    many = fused_zoom.sweep_warm_fused(shape, params, *args)
    monkeypatch.setattr(fused_zoom, "_lanes_for", lambda B, P: 1)
    one = fused_zoom.sweep_warm_fused(shape, params, *args)
    torch.cuda.synchronize()
    assert _same(one, many)


@pytest.mark.cuda
def test_planar_batched_kernel_bitwise_on_card():
    """K2 under PlanarPose at B = 8: bitwise equal to K1 launched per
    scenario, and to its plain version in t* and d*."""
    dev = _cuda()
    per = [_planar_inputs("Box", dev, P=512, seed=30 + b) for b in range(8)]
    shape, params, _ = per[0]
    args = tuple(torch.stack([p[2][i] for p in per]).contiguous()
                 for i in range(6))
    tk, dk, gk = fused_zoom.sweep_warm_fused_batched(shape, params, *args)
    for b, (_, _, a1) in enumerate(per):
        assert _same((tk[b], dk[b], gk[b]),
                     fused_zoom.sweep_warm_fused(shape, params, *a1))
    tr, dr, gr = fused_zoom.sweep_warm_fused_batched_ref(shape, params, *args)
    torch.cuda.synchronize()
    assert _same((tk, dk), (tr, dr))
    assert float((gk - gr).abs().max()) <= G_ATOL


@pytest.mark.cuda
def test_planar_zoom_kernel_bitwise_on_card():
    dev = _cuda()
    shape, params, (pts, tw, _, starts, durs, coeffs) = _planar_inputs(
        "Box", dev)
    args = (pts, tw, torch.full_like(tw, 0.3), starts, durs, coeffs)
    tk = fused_zoom.zoom_refine(shape, params, *args, rounds=8)
    tr = fused_zoom.zoom_refine_ref(shape, params, *args, rounds=8)
    torch.cuda.synchronize()
    assert torch.equal(tk, tr)


@pytest.mark.cuda
@pytest.mark.parametrize("coarse_n,cold", [(64, False), (256, True)])
def test_planar_grid_kernel_bitwise_on_card(coarse_n, cold):
    """K3 under PlanarPose on the torus field: t*, d* and the gradient
    bitwise equal to the plain version's."""
    dev = _cuda()
    grid, _, _ = _grid_inputs(dev, P=8)
    _, params, (pts, tw, _, starts, durs, coeffs) = _planar_inputs(
        "Ball", dev, P=4096)
    args = (pts, torch.zeros_like(tw) if cold else tw, starts, durs, coeffs)
    before = grid_zoom.LAUNCHES_GRID
    got = grid_zoom.grid_sweep_warm_fused(grid, params, *args,
                                          coarse_n=coarse_n, rounds=8)
    assert grid_zoom.LAUNCHES_GRID == before + 1
    want = grid_zoom.grid_sweep_warm_fused_ref(grid, params, *args,
                                               coarse_n=coarse_n, rounds=8)
    torch.cuda.synchronize()
    assert _same(got, want)


@pytest.mark.cuda
def test_shape_without_device_sdf_sweeps_on_the_card():
    """A hand-built analytic shape on CUDA tensors takes the non-fused path
    (its sweeps are counted by sweep_sdf.XLA_CALLS, K1 never launches) and
    agrees with the same cold sweep in float64 on the CPU (1e-4); the K1
    wrapper itself still refuses the shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import importlib

    ss = importlib.import_module("isdf_torch.sweep.sweep_sdf")
    dev = torch.device("cuda")
    shape, params, (pts, tw, pose, starts, durs, coeffs) = _inputs(
        "Ball", dev, P=256)
    bare = Shape("HandBuilt", shape.sdf, shape.bounds, sdf3=shape.sdf3)
    traj = PolyTraj(durs, coeffs)
    before = (ss.XLA_CALLS, fused_zoom.LAUNCHES)
    warm = sweep_sdf_warm(bare, traj, params, pts, tw, coarse_n=64,
                          refine_rounds=8)
    cold = sweep_sdf(bare, traj, params, pts, coarse_n=64, refine_rounds=8)
    torch.cuda.synchronize()
    assert (ss.XLA_CALLS, fused_zoom.LAUNCHES) == (before[0] + 2, before[1])
    assert bool(torch.isfinite(warm[0]).all() & torch.isfinite(cold[0]).all())
    cpu = sweep_sdf(bare, PolyTraj(durs.double().cpu(), coeffs.double().cpu()),
                    params, pts.double().cpu(), coarse_n=64, refine_rounds=8,
                    device="cpu")
    np.testing.assert_allclose(cold[0].cpu().numpy(), cpu[0].numpy(),
                               atol=1e-4)
    with pytest.raises(NotImplementedError, match="HandBuilt"):
        fused_zoom.sweep_warm_fused(bare, params, pts, tw, pose, starts, durs,
                                    coeffs)
