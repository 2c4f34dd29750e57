"""LMBM on demo 1's back end, through both packages from the same start.

Demo 1's first back-end solve starts from the mid end's result.  This script
saves that start (``capture``: the port's planner on demo 1's scene, as
chip_smoke.py builds it, stopped at its first ``backend.optimize`` call; the
file is an ``opt/checkpoint`` .npz with the solve's other inputs beside x)
and solves it again with ``method="lmbm"`` in the JAX package and in the
port, in float32 and float64 (``solve``), printing one JSON line a run:
iterations, evaluations, final cost, and how far x moved from the solve's
own start (x moves only on a serious step, so 0 means none was made).
The JAX package's LMBM does not count its steps; the port's also gives its
serious and null steps and restarts.

    JAX_PLATFORMS=cpu python tests/lmbm_demo1_witness.py capture OUT.npz
    JAX_PLATFORMS=cpu python tests/lmbm_demo1_witness.py solve OUT.npz \\
        [--iters 200] [--runs jax32,jax64,torch32,torch64]

``capture --device cuda`` takes the start from the card's planner instead.
Both steps run at demo 1's full configuration (4,096 obstacle points,
coarse 128, 24 rounds); a 200-iteration solve is minutes on a CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KEYS = ("head", "tail", "q0", "T0", "points", "mask")


class _Stop(Exception):
    pass


def capture(out: str, device: str) -> None:
    import torch

    import chip_smoke
    from isdf_torch.config import Config
    from isdf_torch.core import timemap
    from isdf_torch.opt import backend, checkpoint
    from isdf_torch.plan import PlannerManager
    from isdf_torch.world import GridMap, maps_gen

    conf = Config(**chip_smoke.DEMO1)
    pm = PlannerManager(conf, shape_name="RoundedCone", device=device)
    gm = GridMap.from_points(maps_gen.map4(res=0.8, seed=0), None,
                             conf.occupancy_resolution, conf.sta_threshold,
                             device=device)
    pm.set_map(gm)
    seen = {}

    def first_solve(shape, conf, head, tail, q0, T0, points, mask, **kw):
        seen.update(head=head, tail=tail, q0=q0, T0=T0, points=points,
                    mask=mask, rot_refs=kw.get("rot_refs"))
        raise _Stop

    optimize, backend.optimize = backend.optimize, first_solve
    try:
        pm.plan(np.asarray(chip_smoke.START), np.asarray(chip_smoke.GOAL))
    except _Stop:
        pass
    finally:
        backend.optimize = optimize
    if not seen:
        raise RuntimeError("the plan never reached its back end")
    if seen["rot_refs"] is not None:
        raise RuntimeError("demo 1's back end takes no attitude refs")
    with torch.no_grad():
        x0 = backend.pack(timemap.T_to_tau(seen["T0"]), seen["q0"])
    checkpoint.save(out, x0, torch.zeros(len(seen["points"])), conf,
                    {k: seen[k] for k in KEYS})
    print(json.dumps(dict(saved=out, device=device,
                          n_pieces=int(seen["T0"].shape[0]),
                          points=int(seen["points"].shape[0]))))


def _jax_run(data, conf_kw, dtype_name: str, iters: int) -> dict:
    import jax

    if dtype_name == "float64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from isdf_tpu.config import Config
    from isdf_tpu.core import timemap
    from isdf_tpu.opt import backend
    from isdf_tpu.shapes import make_shape

    dt = jnp.float64 if dtype_name == "float64" else jnp.float32
    conf = Config(**conf_kw)
    shape = make_shape("RoundedCone", conf)
    arr = {k: jnp.asarray(data[k], dt) for k in KEYS if k != "mask"}
    x0 = backend.pack(timemap.T_to_tau(arr["T0"]), arr["q0"])
    t0 = time.perf_counter()
    _, res = backend.optimize(
        shape, conf, arr["head"], arr["tail"], arr["q0"], arr["T0"],
        arr["points"], jnp.asarray(data["mask"]), max_iters=iters,
        method="lmbm")
    jax.block_until_ready(res.x)
    wall = time.perf_counter() - t0
    return dict(wall_s=wall, iters=int(res.n_iters), evals=int(res.n_evals),
                final_cost=float(res.f), converged=bool(res.converged),
                x_moved=float(jnp.max(jnp.abs(res.x - x0))))


def _torch_run(data, conf_kw, dtype_name: str, iters: int) -> dict:
    import torch

    from isdf_torch.config import Config
    from isdf_torch.core import timemap
    from isdf_torch.opt import backend
    from isdf_torch.shapes import make_shape

    dt = getattr(torch, dtype_name)
    conf = Config(**conf_kw)
    shape = make_shape("RoundedCone", conf)
    x0 = backend.pack(timemap.T_to_tau(torch.as_tensor(data["T0"], dtype=dt)),
                      torch.as_tensor(data["q0"], dtype=dt))
    t0 = time.perf_counter()
    _, res = backend.optimize(
        shape, conf, data["head"], data["tail"], data["q0"], data["T0"],
        data["points"], data["mask"], max_iters=iters, method="lmbm",
        device="cpu", dtype=dt)
    wall = time.perf_counter() - t0
    return dict(wall_s=wall, iters=int(res.n_iters), evals=int(res.n_evals),
                final_cost=float(res.f), converged=bool(res.converged),
                x_moved=float((res.x - x0).abs().max()), **(res.stats or {}))


def solve(path: str, iters: int, runs) -> None:
    import chip_smoke

    npz = np.load(path, allow_pickle=False)
    data = {k: npz[k] for k in npz.files}
    for run in runs:
        pkg, bits = run[:-2], run[-2:]
        dtype_name = "float" + bits
        fn = _jax_run if pkg == "jax" else _torch_run
        rec = fn(data, dict(chip_smoke.DEMO1), dtype_name, iters)
        print(json.dumps(dict(run=run, **rec)), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("capture")
    c.add_argument("out")
    c.add_argument("--device", default="cpu")
    s = sub.add_parser("solve")
    s.add_argument("path")
    s.add_argument("--iters", type=int, default=200)
    s.add_argument("--runs", default="jax32,jax64,torch32,torch64")
    a = ap.parse_args()
    if a.cmd == "capture":
        capture(a.out, a.device)
    else:
        solve(a.path, a.iters, a.runs.split(","))


if __name__ == "__main__":
    main()
