"""Checks of the multi-device path, and the launcher of its ranks
(counterpart of the checks in ``__graft_entry__.py``: ``entry``,
``dryrun_multichip`` and ``dryrun_multihost``).

In PyTorch every rank is a process, so JAX's two dryruns, one process with
eight devices and two processes under ``jax.distributed``, are one function
here: :func:`dryrun` spawns ``world`` ranks, each in a process group of the
given backend, joined through ``init_method`` (a file, by default in a fresh
temporary directory, or ``tcp://host:port``).  Run it with gloo on the CPU
(``device="cpu"``), or with ranks on the card (default; ranks share a card
when there are more ranks than cards, and then only gloo, whose collectives
stage CUDA tensors through the host, accepts them).

    python -m isdf_torch.parallel.dryrun [--world 2] [--sp 2]
        [--backend gloo] [--device cpu]
"""

from __future__ import annotations

import argparse
import datetime
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from isdf_torch.config import Config
from isdf_torch.core import flatness as fl
from isdf_torch.core import timemap
from isdf_torch.device import resolve_device
from isdf_torch.opt import backend
from isdf_torch.parallel import batch as pb
from isdf_torch.shapes import grid_shape, make_shape
from isdf_torch.sweep import fused_zoom, grid_zoom

# a rank waits at most this long in one collective before it raises
COLLECTIVE_TIMEOUT_S = 300


def tiny_conf() -> Config:
    """The configuration of the checks in ``__graft_entry__.py``."""
    return Config(integralIntervs=8, sweep_coarse_samples=16,
                  sweep_refine_rounds=6, vmax=5.0, omgmax=5.0,
                  thetamax=1.5, safety_hor=0.4)


def entry(device=None):
    """→ (fn, (x0, t_warm)): one full back-end cost+gradient evaluation
    (MINCO solve, flatness, dynamic penalties, the swept-volume SDF of 256
    obstacle points, autograd), CappedCone, N = 4; fn(x, t_warm) → (f, g,
    t*).  The computation the optimizer loop runs every iteration."""
    dev = resolve_device(device)
    conf = tiny_conf()
    shape = make_shape("CappedCone", conf)
    N, P = 4, 256

    def on(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    head = on(np.zeros((3, 3)))
    tail = np.zeros((3, 3))
    tail[:, 0] = (8.0, 2.0, 1.0)
    rng = np.random.default_rng(0)
    q0 = (np.linspace(1, 7, N - 1)[:, None] * np.array([1.0, 0.25, 0.12])
          + rng.normal(scale=0.1, size=(N - 1, 3)))
    x0 = backend.pack(timemap.T_to_tau(on(np.full(N, 2.0))), on(q0))
    points = on(rng.uniform(0, 8, size=(P, 3)))
    cost_and_grad = backend.make_cost_fn(
        shape, fl.FlatParams.from_config(conf),
        backend.BackendWeights.from_config(conf), head, on(tail), N, points,
        on(np.ones(P), torch.bool), integral_res=conf.integralIntervs,
        coarse_n=conf.sweep_coarse_samples,
        refine_rounds=conf.sweep_refine_rounds)
    return cost_and_grad, (x0, torch.zeros(P, device=dev))


def grid_test_shape(device=None):
    """A small baked voxel SDF, a torus on a 17 × 17 × 9 grid at 0.1 m: the
    mesh-robot shape class (K3) without the reference's OBJ assets."""
    nx, ny, nz, res = 17, 17, 9, 0.1
    origin = np.array([-0.8, -0.8, -0.4])
    ii = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                              indexing="ij"), axis=-1)
    p = origin + ii * res
    xy = np.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2) - 0.4
    field = np.sqrt(xy ** 2 + p[..., 2] ** 2) - 0.18
    return grid_shape("dryrun_torus", field, origin, res, device=device)


def _rank_main(rank, fn, world, backend_name, init_method, args):
    # ranks share the host's cores: intra-op threads of several ranks
    # oversubscribe them (measured 3-4x slower with 2-4 ranks on 8 cores)
    torch.set_num_threads(1)
    dist.init_process_group(
        backend_name, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, args=(), backend_name: str = "gloo",
              init_method=None, timeout: float = 120.0) -> None:
    """Run ``fn(rank, *args)`` in ``world`` processes started with the
    spawn method, each inside an initialised process group of
    ``backend_name`` joined through ``init_method`` (default: a file in a
    fresh temporary directory).  ``fn`` must be importable by its module
    path.  Raises if a rank raises or exits non-zero, and kills every rank
    that is still running after ``timeout`` seconds and raises."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        if init_method is None:
            init_method = f"file://{tmp}/rdzv"
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, backend_name, init_method,
                              tuple(args)),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{world} ranks still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError("dryrun: " + what)


def _launches():
    return {"K2": fused_zoom.LAUNCHES_BATCHED, "K3": grid_zoom.LAUNCHES_GRID}


def dryrun_rank(rank, world, sp, device, outdir):
    """One rank of :func:`dryrun`: the sections of JAX's dryrun_multichip;
    writes its record to ``outdir/rank{rank}.json``."""
    conf = tiny_conf().replace(integralIntervs=4, sweep_coarse_samples=8,
                               sweep_refine_rounds=3, mem_size=4)
    shape = make_shape("Ball", conf)
    rec = {"rank": rank, "world": world}

    def section(name, t0, l0):
        rec[name] = dict(s=time.perf_counter() - t0, **{
            k: v - l0[k] for k, v in _launches().items()})

    # 1. a cost+grad over the (dp, sp) mesh: scenarios over dp, points over
    # dp × sp
    t0, l0 = time.perf_counter(), _launches()
    mesh = pb.make_mesh(world, sp=sp, device=device)
    dev = mesh.device
    rec["device"] = str(dev)
    B = max(2 * (world // sp), 2)
    sb = pb.make_random_batch(conf, B, N=3, n_points=8 * sp, device=dev)
    costs, grads = pb.batched_cost_and_grad(
        shape, conf, pb.shard_batch(sb, mesh), device=dev)
    _check(tuple(costs.shape) == (B,) and tuple(grads.shape) == (B, 9),
           f"section 1: shapes {tuple(costs.shape)}, {tuple(grads.shape)}")
    _check(bool(torch.isfinite(costs).all() & torch.isfinite(grads).all()),
           "section 1: non-finite costs or gradients")
    rec["mesh"] = dict(shape=list(mesh.shape), dp_idx=mesh.dp_idx,
                       sp_idx=mesh.sp_idx)
    section("section1_dp_sp_cost_grad", t0, l0)

    # 2. the chunked solve over dp, one chunk: rolling the scenarios by one
    # moves each to another rank (and another row of its block), and the
    # per-rank shapes stay the same, so the results roll bitwise
    t0, l0 = time.perf_counter(), _launches()
    mesh_dp = pb.make_mesh(world, sp=1, device=dev)
    B2 = 2 * world
    sb2 = pb.make_random_batch(conf, B2, N=3, n_points=16, seed=7,
                               device=dev)
    rolled = sb2.map(lambda t: torch.roll(t, 1, 0))
    kw = dict(max_iters=4, chunk=4, device=dev)
    out = pb.batched_solve_chunked(shape, conf, pb.shard_batch(sb2, mesh_dp),
                                   **kw)
    out_r = pb.batched_solve_chunked(shape, conf,
                                     pb.shard_batch(rolled, mesh_dp), **kw)
    _check(bool(torch.isfinite(out[2]).all()), "section 2: non-finite costs")
    for name, a, b in zip(("coeffs", "T", "costs", "iters"), out, out_r):
        _check(tuple(a.shape[:1]) == (B2,), f"section 2: {name} not whole")
        _check(torch.equal(torch.roll(b, -1, 0), a),
               f"section 2: the dp solve's {name} depends on placement")
    section("section2_dp_chunked_equivariance", t0, l0)

    # 3. the grid (mesh-robot) shape class: a dp cost+grad through K3
    t0, l0 = time.perf_counter(), _launches()
    f_g, g_g = pb.batched_cost_and_grad(
        grid_test_shape(dev), conf, pb.shard_batch(sb2, mesh_dp), device=dev)
    _check(bool(torch.isfinite(f_g).all() & torch.isfinite(g_g).all()),
           "section 3: non-finite grid costs or gradients")
    section("section3_grid_dp_cost_grad", t0, l0)

    # 4. the sp axis: section 1 against an unsharded evaluation; the point
    # sum over sp changes only its reduction order
    t0, l0 = time.perf_counter(), _launches()
    f_ref, g_ref = pb.batched_cost_and_grad(shape, conf, sb, device=dev)
    np.testing.assert_allclose(
        costs.cpu().numpy(), f_ref.cpu().numpy(), rtol=1e-4,
        err_msg="sp-sharded cost diverges beyond reduction-order tolerance")
    np.testing.assert_allclose(
        grads.cpu().numpy(), g_ref.cpu().numpy(), rtol=5e-3, atol=1e-4,
        err_msg="sp-sharded gradient diverges")
    rec["section4_rel_cost"] = float(
        ((costs - f_ref).abs() / f_ref.abs()).max())
    section("section4_sp_against_unsharded", t0, l0)
    Path(outdir, f"rank{rank}.json").write_text(json.dumps(rec))


def dryrun(world: int = 2, sp: int = 2, backend_name: str = "gloo",
           device=None, init_method=None, timeout: float = 300.0) -> list:
    """JAX's dryrun_multichip over ``world`` spawned ranks → their records
    (sections' seconds and K2/K3 launches).  sp must divide world.  Raises
    if any check of any rank fails."""
    resolve_device(device)
    with tempfile.TemporaryDirectory() as outdir:
        run_ranks(dryrun_rank, world, (world, sp, device, outdir),
                  backend_name=backend_name, init_method=init_method,
                  timeout=timeout)
        return [json.loads(Path(outdir, f"rank{r}.json").read_text())
                for r in range(world)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--sp", type=int, default=2)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    fn, args = entry(a.device)
    f, g, _ = fn(*args)
    print("entry ok:", float(f))
    for rec in dryrun(a.world, a.sp, a.backend, a.device):
        print(json.dumps(rec))
    print("dryrun ok")


if __name__ == "__main__":
    main()
