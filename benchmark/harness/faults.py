"""Faults planted underneath a cell's timed path, to show that the check
sees them: each is a context manager over the program's entry points,
for the traffic's driver (``batch_solve`` or ``plan``).

* ``unchanged``: every solve returns its start (no iteration runs);
* ``altered``: the answer is altered where it is produced (a batch's costs
  x 1.01, a plan's second piece moved 5 cm);
* ``cut_short``: every solve stops after 8 accepted steps (a batch: one
  chunk of its 24 iterations);
* ``no_sweep_grad``: the swept SDF's value is right and its gradient zero;
* ``half_left``: half of a batch's scenarios are left unsolved, their
  starts returned as answers;
* ``points_left``: a plan's obstacle gathers leave out a quarter of the
  occupied voxels they find.

The benchmark's own runs plant none: ``benchmark/control.py --fault`` and
the CPU tests do."""

from __future__ import annotations

import contextlib

CUT = 8          # accepted steps a cut-short solve makes


@contextlib.contextmanager
def _patch(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _capped(k: dict, iters: int) -> dict:
    return dict(k, max_iters=iters)


def unchanged(driver: str):
    if driver == "plan":
        from isdf_torch.opt import backend
        fn = backend.optimize
        return _patch(backend, "optimize",
                      lambda *a, **k: fn(*a, **_capped(k, 0)))
    from isdf_torch.opt import lbfgs
    fn = lbfgs.minimize_lockstep
    return _patch(lbfgs, "minimize_lockstep",
                  lambda *a, **k: fn(*a, **_capped(k, 0)))


def altered(driver: str):
    if driver == "plan":
        from isdf_torch.plan import manager
        fn = manager.PlannerManager.plan

        def plan(self, *a, **k):
            res = fn(self, *a, **k)
            if res.success:
                res.traj.coeffs[1, 0] += 0.05
            return res
        return _patch(manager.PlannerManager, "plan", plan)
    from isdf_torch.parallel import batch
    fn = batch.batched_solve_chunked

    def solve(*a, **k):
        c, T, f, it = fn(*a, **k)
        return c, T, f * 1.01, it
    return _patch(batch, "batched_solve_chunked", solve)


def cut_short(driver: str):
    if driver == "plan":
        from isdf_torch.opt import backend
        fn = backend.optimize
        return _patch(backend, "optimize",
                      lambda *a, **k: fn(*a, **_capped(k, CUT)))
    from isdf_torch.parallel import batch
    fn = batch.batched_solve_chunked
    return _patch(batch, "batched_solve_chunked",
                  lambda *a, **k: fn(*a, **_capped(k, CUT)))


def no_sweep_grad(driver: str):
    from isdf_torch.opt import backend
    fn = backend.sweep_sdf_warm

    def sweep(*a, **k):
        sdf, *rest = fn(*a, **k)
        return (sdf.detach(), *rest)
    return _patch(backend, "sweep_sdf_warm", sweep)


def half_left(driver: str):
    import torch

    from isdf_torch.opt import backend
    from isdf_torch.parallel import batch
    fn = batch.batched_solve_chunked

    def solve(shape, conf, b, *a, **k):
        c, T, f, it = fn(shape, conf, b, *a, **k)
        h = len(T) // 2
        c0, T0, _ = backend.build_traj(batch._x0(b), T.shape[1], b.head,
                                       b.tail)
        f0, _ = batch.batched_cost_and_grad(shape, conf, b, device=b.device)

        def cat(x, x0):
            return torch.cat([x[:h], x0[h:].to(x.dtype)])
        return (cat(c, c0.coeffs.detach()), cat(T, T0.detach()), cat(f, f0),
                cat(it, torch.zeros_like(it)))
    return _patch(batch, "batched_solve_chunked", solve)


def points_left(driver: str):
    from isdf_torch.world import aabb
    fn = aabb.gather_aabb_points

    def gather(*a, **k):
        pts, mask = fn(*a, **k)
        mask = mask.copy()
        live = mask.nonzero()[0]
        mask[live[::4]] = False
        return pts, mask
    return _patch(aabb, "gather_aabb_points", gather)


FAULTS = {f.__name__: f for f in (unchanged, altered, cut_short,
                                  no_sweep_grad, half_left, points_left)}
# shows only at a cell's own size and iterations: the card's test reads it
# in the cells whose limits file lists it under "card_faults"
CELL_SIZE_ONLY = ("cut_short",)
# the faults each driver's cells can have
FOR = {"batch_solve": ("unchanged", "altered", "cut_short", "no_sweep_grad",
                       "half_left"),
       "plan": ("unchanged", "altered", "cut_short", "no_sweep_grad",
                "points_left")}


def plant(name: str, driver: str):
    if name not in FOR[driver]:
        raise KeyError(f"no fault {name!r} for the {driver} driver")
    return FAULTS[name](driver)
