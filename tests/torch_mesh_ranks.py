"""Rank functions of tests/test_torch_multidevice.py, each run in spawned
processes by ``isdf_torch.parallel.dryrun.run_ranks`` inside a gloo process
group on the CPU, float64.  Every rank builds the same global batch from the
same seed and writes what the test compares to ``outdir`` as
``<case>_r<rank>.npz``.  This module imports torch, numpy and isdf_torch
only: nothing of JAX reaches a rank."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

from isdf_torch.config import Config
from isdf_torch.opt import backend
from isdf_torch.parallel import batch as pb
from isdf_torch.shapes import make_shape
from isdf_torch.sweep.fast_eval import sdf_at_time_c

F64 = torch.float64
CPU = "cpu"
# tests/test_parallel.py's configuration and sizes
CONF = dict(integralIntervs=4, sweep_coarse_samples=8, sweep_refine_rounds=3,
            mem_size=4, vmax=5.0, omgmax=5.0, thetamax=1.5, safety_hor=0.4)
B, N, P = 8, 3, 16
OUT = ("coeffs", "T", "f", "iters")
# scenarios 1, 2, 3, 6 of the seed-0 batch under CONVERGE, solved in chunks
# of 4 accepts up to 12: 1 and 2 (rank 0's at dp = 2) converge in chunk 2,
# 3 and 6 (rank 1's) run on to the end
CONVERGE = dict(relCostTol=1e-3, past=2)
CONVERGE_ROWS = [1, 2, 3, 6]
CONVERGE_KW = dict(max_iters=12, chunk=4, device=CPU)


def conf(**kw):
    return Config(**{**CONF, **kw})


def shapes(c):
    """Ball through K2's plain version (the kernel's algorithm, as on the
    card) and Ball without a device SDF, whose sweep is the non-fused path
    (the algorithm JAX runs on the CPU)."""
    ball = make_shape("Ball", c)
    return {"fused": ball, "nonfused": dataclasses.replace(ball, spec=None)}


def batch(c, seed=0, rows=None, **kw):
    sb = pb.make_random_batch(c, kw.pop("B", B), N=N, n_points=kw.pop(
        "P", P), seed=seed, device=CPU, dtype=F64)
    if rows is not None:
        sb = sb.map(lambda t: t[rows])
    return sb


def save(outdir, case, rank, **arrays):
    np.savez(Path(outdir, f"{case}_r{rank}.npz"), **{
        k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        for k, v in arrays.items()})


def loaded_modules():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "isdf_tpu"))


def solves(rank, world, outdir, sps):
    """batched_solve(max_iters=3) of the seed-0 batch on a (world/sp, sp)
    mesh for each sp in ``sps``, both sweep paths."""
    c = conf()
    for sp in sps:
        mesh = pb.make_mesh(world, sp=sp, device=CPU)
        for path, shape in shapes(c).items():
            out = pb.batched_solve(shape, c, pb.shard_batch(batch(c), mesh),
                                   max_iters=3, device=CPU)
            save(outdir, f"solve_{world // sp}x{sp}_{path}", rank,
                 **dict(zip(OUT, out)))


def sp_cost_grad(rank, outdir):
    """One cost+gradient evaluation on a (1, 2) mesh at a perturbed x and
    random warm starts: f, g and this rank's t*; then the gradient against
    central differences of the same sharded cost with every point's t* held
    at this evaluation's (the envelope gradient the cost returns)."""
    c = conf()
    shape = make_shape("Ball", c)
    mesh = pb.make_mesh(2, sp=2, device=CPU)
    full = batch(c)
    sb = pb.shard_batch(full, mesh)
    rng = np.random.default_rng(3)
    x = pb._x0(sb) + torch.as_tensor(
        rng.normal(scale=0.05, size=(B, 4 * N - 3)))
    tw = torch.as_tensor(rng.uniform(0.0, 3.0, size=(B, P)))[:, mesh.block(
        P, "sp")]
    cost = pb._cost_fn(shape, c, sb)
    f, g, t_star = cost(x, tw)

    def frozen(shape_, traj, params_, points, t_warm, **kw):
        pw = (points[..., 0], points[..., 1], points[..., 2])
        return sdf_at_time_c(shape_, traj, params_, pw, t_star), t_star, None

    real = backend.sweep_sdf_warm
    backend.sweep_sdf_warm = frozen
    try:
        f_frozen = cost(x, tw)[0]
        h = 1e-6
        fd = torch.empty_like(g)
        for i in range(x.shape[1]):
            e = torch.zeros_like(x)
            e[:, i] = h
            fd[:, i] = (cost(x + e, tw)[0] - cost(x - e, tw)[0]) / (2 * h)
    finally:
        backend.sweep_sdf_warm = real
    save(outdir, "sp_cost_grad", rank, x=x, tw=tw, f=f, g=g, t_star=t_star,
         f_frozen=f_frozen, fd=fd, sp_idx=mesh.sp_idx)


def equivariance(rank, world, outdir):
    """batched_solve over dp of the seed-0 batch and of the batch rolled by
    one scenario: the rolled results, rolled back, equal the others."""
    c = conf()
    shape = make_shape("Ball", c)
    mesh = pb.make_mesh(world, sp=1, device=CPU)
    sb = batch(c)
    rolled = sb.map(lambda t: torch.roll(t, 1, 0))
    out = pb.batched_solve(shape, c, pb.shard_batch(sb, mesh), max_iters=3,
                           device=CPU)
    out_r = pb.batched_solve(shape, c, pb.shard_batch(rolled, mesh),
                             max_iters=3, device=CPU)
    save(outdir, "equivariance", rank,
         **dict(zip(OUT, out)),
         **{f"{k}_rolled": v for k, v in zip(OUT, out_r)})


def converge_apart(rank, world, outdir):
    """The chunked solve of CONVERGE_ROWS on a (2, 1) mesh: rank 0's
    scenarios converge chunks before rank 1's.  Records, per chunk, whether
    this rank's scenarios have all converged."""
    c = conf(**CONVERGE)
    mesh = pb.make_mesh(world, sp=1, device=CPU)
    local_done = []
    out = pb.batched_solve_chunked(
        make_shape("Ball", c), c,
        pb.shard_batch(batch(c, rows=CONVERGE_ROWS), mesh), **CONVERGE_KW,
        callback=lambda res: local_done.append(bool(res.converged.all())))
    save(outdir, "converge_apart", rank, local_done=local_done,
         **dict(zip(OUT, out)))


def audit_case(c):
    """tests/test_parallel.py's unseen-reserve case at B = 4: the solve's
    points lie far off the route, a reserve point on it."""
    sb = batch(c, B=4, P=8)
    goals = sb.tail[:, :, 0]
    pts = (goals[:, None, :] + torch.tensor([0.0, 8.0, 8.0],
                                            dtype=F64)).expand(-1, 8, -1)
    sb = dataclasses.replace(sb, points=pts.contiguous())
    rsv = (goals + torch.tensor([0.0, 9.0, 9.0], dtype=F64))[:, None, :] \
        .repeat(1, 6, 1)
    rsv[:, 0, :] = 0.5 * goals
    return sb, rsv


AUDIT_KW = dict(max_iters=4, chunk=4, audit_coarse_n=256, inject_budget=4,
                device=CPU)


def audited(rank, world, outdir, sp):
    c = conf()
    mesh = pb.make_mesh(world, sp=sp, device=CPU)
    sb, rsv = audit_case(c)
    out = pb.batched_solve_audited(make_shape("Ball", c), c,
                                   pb.shard_batch(sb, mesh),
                                   reserve_points=rsv, **AUDIT_KW)
    save(outdir, f"audited_{world // sp}x{sp}", rank,
         violations=out[4]["violations_per_round"],
         min_sdf=out[4]["min_sdf"],
         **dict(zip(OUT, out[:4])))


def no_mesh(outdir):
    """The references without a mesh: batched_solve(max_iters=3) on both
    paths, the chunked solve of CONVERGE_ROWS, the audited solve."""
    c = conf()
    for path, shape in shapes(c).items():
        out = pb.batched_solve(shape, c, batch(c), max_iters=3, device=CPU)
        save(outdir, f"solve_none_{path}", 0, **dict(zip(OUT, out)))
    cc = conf(**CONVERGE)
    out = pb.batched_solve_chunked(make_shape("Ball", cc), cc,
                                   batch(cc, rows=CONVERGE_ROWS),
                                   **CONVERGE_KW)
    save(outdir, "converge_none", 0, **dict(zip(OUT, out)))
    sb, rsv = audit_case(c)
    out = pb.batched_solve_audited(make_shape("Ball", c), c, sb,
                                   reserve_points=rsv, **AUDIT_KW)
    save(outdir, "audited_none", 0, violations=out[4]["violations_per_round"],
         min_sdf=out[4]["min_sdf"], **dict(zip(OUT, out[:4])))


def world1(rank, outdir):
    """A (1, 1) mesh against no mesh, in the same process: the chunked and
    the audited solve; then the references without a mesh."""
    c = conf()
    shape = make_shape("Ball", c)
    mesh = pb.make_mesh(1, sp=1, device=CPU)
    sb, rsv = audit_case(c)
    res = {}
    for tag, b in (("mesh", pb.shard_batch(sb, mesh)), ("none", sb)):
        chunked = pb.batched_solve_chunked(shape, c, b, max_iters=4, chunk=2,
                                           device=CPU)
        aud = pb.batched_solve_audited(shape, c, b, reserve_points=rsv,
                                       **AUDIT_KW)
        res.update({f"{tag}_chunked_{i}": v for i, v in enumerate(chunked)})
        res.update({f"{tag}_audited_{i}": v for i, v in enumerate(aud[:4])})
        res[f"{tag}_min_sdf"] = aud[4]["min_sdf"]
        res[f"{tag}_violations"] = aud[4]["violations_per_round"]
    save(outdir, "world1", rank, modules=loaded_modules(), **res)
    no_mesh(outdir)


def world2(rank, outdir):
    solves(rank, 2, outdir, (1, 2))
    sp_cost_grad(rank, outdir)
    equivariance(rank, 2, outdir)
    converge_apart(rank, 2, outdir)
    save(outdir, "modules", rank, modules=loaded_modules())


def world4(rank, outdir):
    solves(rank, 4, outdir, (2,))
    audited(rank, 4, outdir, 2)


def sleep_forever(rank):
    """A rank that never ends: run_ranks must kill it at its timeout."""
    import time

    time.sleep(3600)
