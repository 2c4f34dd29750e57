"""K1 on the card against its plain PyTorch version.

This file imports neither JAX nor isdf_tpu, so it also runs where JAX is
not installed (tests/conftest.py imports JAX; leave it out there):

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Without a card the card tests skip; the wrapper's argument and build checks
run everywhere."""

import numpy as np
import pytest
import torch

from isdf_torch.config import Config
from isdf_torch.core import flatness as fl
from isdf_torch.core import minco
from isdf_torch.core.poly import PolyTraj
from isdf_torch.shapes import make_shape
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
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, params, args = _inputs("Ball", torch.device("cuda"), P=256)
    with pytest.raises(NotImplementedError, match="Torus"):
        fused_zoom.sweep_warm_fused(make_shape("Torus"), params, *args)
