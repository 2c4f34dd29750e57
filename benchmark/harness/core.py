"""One run of one cell of the benchmark: set-up, the measured window, the
check against the reference, the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is data found by name: ``BENCHMARK.json`` at the root names the
cell's configuration and traffic; the configuration's file is the one its
entry names; the traffic mix is ``benchmark/traffic/<traffic>.json``, whose
``driver`` names the loop in ``benchmark/harness/drivers/``; the limits of
the check are ``benchmark/limits/<cell>.json``; each per-layer metric is
``benchmark/metrics/<metric>.py``, a ``read(rec)`` that returns a number or
None.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

BANNED = ("jax", "jaxlib", "flax", "isdf_tpu")


@dataclass
class Context:
    """What a driver needs of one run."""

    root: Path                   # holds BENCHMARK.json and benchmark/
    cell: dict
    config: dict                 # the configuration's file
    traffic: dict                # the traffic mix's file
    limits: dict                 # {number: limit}
    metrics: dict                # per-layer {name: (entry, read)}
    seed: int
    seconds: float
    trace: bool
    device: Any = None           # torch.device
    t_process: float = 0.0       # perf_counter at process start
    e2e: dict = field(default_factory=dict)   # reported: {name: unit}

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_reader(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_context(root: Path, name: str, seed: int, seconds: float,
                 trace: bool, hook: Optional[dict] = None) -> Context:
    """The cell ``name`` of ``root``/BENCHMARK.json with its files; ``hook``
    (tests only) overrides settings, traffic parameters and the limits of
    numbers that read otherwise at a test's tiny sizes."""
    spec = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = _load_json(root / cfg_entry["file"])
    traffic = _load_json(root / "benchmark" / "traffic"
                         / f"{cell['traffic']}.json")
    limits = _load_json(root / "benchmark" / "limits" / f"{name}.json")
    if hook:
        config = dict(config, settings=dict(config["settings"],
                                            **hook.get("settings", {})))
        traffic = dict(traffic, **hook.get("traffic", {}))
        limits = dict(limits, limits={
            k: hook.get("limits", {}).get(k, v)
            for k, v in limits["limits"].items()})
    reported = {m["name"] for m in spec["end_to_end"]
                if name in m.get("workloads", [name])}
    metrics = {}
    for m in spec["per_layer"]:
        if name in m.get("workloads", [name] if m["moves"] in reported
                         else []):
            path = root / "benchmark" / "metrics" / f"{m['name']}.py"
            metrics[m["name"]] = (m, _load_reader(path))
    e2e = [m for m in spec["end_to_end"] if m["name"] in reported]
    ctx = Context(root, cell, config, traffic, limits["limits"], metrics,
                  seed, seconds, trace)
    ctx.e2e = {m["name"]: m["unit"] for m in e2e}
    return ctx


def banned_modules():
    """Top-level names in sys.modules that the benchmark must not load,
    compared whole: ``isdf_torch`` is not ``isdf_tpu``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def _card(dev) -> dict:
    import subprocess

    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=60)
        info["power_limit_w"] = float(out.stdout.strip())
    except (OSError, ValueError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def within(checks: dict, limits: dict) -> bool:
    """Whether every number the limits name was read, is finite and lies
    within its limit.  A driver may read more numbers than a cell
    compares."""
    return all(math.isfinite(checks.get(k, math.nan)) and checks[k] <= v
               for k, v in limits.items())


def run_cell(ctx: Context, driver) -> dict:
    """Set-up, window, check → the result object (without printing)."""
    import torch

    state = driver.setup(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_process
    win = driver.window(ctx, state)
    ctx.sync()
    t_window = time.perf_counter()
    if ctx.device.type == "cuda":
        device = _card(ctx.device)
        device["memory_peak_bytes"] = int(
            torch.cuda.max_memory_allocated(ctx.device))
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 0,
                  "memory_peak_bytes": None}
    metrics = {}
    attempted = win["attempted"]
    if ctx.trace:
        rec = win["records"]
        for name, (entry, read) in ctx.metrics.items():
            v = read(rec)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": entry["unit"]}
        prof = rec.get("profile")
        if prof:
            device["busy_s"] = prof["busy_ns"] * 1e-9
            device["window_s"] = prof["window_ns"] * 1e-9
    else:
        e2e = dict(win["e2e"], setup_s=setup_s)
        metrics = {k: {"value": float(e2e[k]), "unit": u}
                   for k, u in ctx.e2e.items() if k in e2e}
    breakdown = win["records"].get("breakdown") if ctx.trace else None
    walls = win["walls"]
    answers = driver.answers(ctx, state, win)
    del state, win           # the program's state, before the reference runs
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = driver.check(ctx, answers)
    correct = within(checks, ctx.limits)
    print(f"benchmark: set-up {setup_s:.1f} s, window and answers "
          f"{t_window - ctx.t_process - setup_s:.1f} s, check "
          f"{time.perf_counter() - t_window:.1f} s; requests (s): "
          f"{[round(w, 3) for w in walls]}", file=sys.stderr)
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown:
        result["breakdown"] = breakdown
    # a number that could not be read (no answer to judge) is null: the
    # line stays strict JSON
    result["checks"] = {
        k: {"value": float(checks[k]) if math.isfinite(
            checks.get(k, math.nan)) else None, "limit": lim}
        for k, lim in ctx.limits.items()}
    return result


def control_readings(ctx: Context, driver, control: bool = True) -> dict:
    """One seed of the control: the cell's set-up and window, then the
    readings of the program's answers and (with ``control``) of the
    control's, the reference in bfloat16 in the program's place, on the
    same requests."""
    state = driver.setup(ctx)
    win = driver.window(ctx, state)
    answers = driver.answers(ctx, state, win)
    attempted = win["attempted"]
    del state, win
    t0 = time.perf_counter()
    program, failed = driver.check(ctx, answers)
    out = {"seed": ctx.seed, "attempted": attempted, "failed": failed,
           "program": program, "check_s": time.perf_counter() - t0}
    if control:
        out["control"] = driver.control(ctx, answers)
    return out


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _device(cell_chips: int, device):
    import torch
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell_chips:
        print(f"benchmark: {cell_chips} CUDA card(s) wanted, "
              f"{torch.cuda.device_count()} present; the benchmark runs on "
              "the card only", file=sys.stderr)
        return None
    return torch.device("cuda:0")


def main(argv, t_process: float, root: Path, device=None,
         hook: Optional[dict] = None) -> int:
    """The command line's run; ``device`` and ``hook`` are for the CPU
    rehearsal of the tests, which never goes through the command line."""
    args = parse(argv)
    cache = root / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    import torch

    ctx = load_context(root, args.workload, args.seed, args.seconds,
                       bool(args.trace), hook)
    ctx.device = _device(ctx.cell["chips"], device)
    if ctx.device is None:
        return 3
    ctx.t_process = t_process
    torch.manual_seed(args.seed)
    driver = importlib.import_module(
        f"benchmark.harness.drivers.{ctx.traffic['driver']}")
    result = run_cell(ctx, driver)
    found = banned_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    for k, v in result["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
