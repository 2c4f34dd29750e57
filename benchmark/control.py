"""The control of a cell's check, on the card: for each seed, the cell's
set-up and a window of ``--seconds``, then the readings of the program's
answers and of the control's, the plain reference computed in bfloat16 in
the program's place, one JSON line a seed:

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--fault <name>]

With ``--fault`` the program runs with that fault of
``benchmark/harness/faults.py`` planted underneath, and the line holds the
program's readings alone, as with ``--program-only``.  The benchmark's own runs never run it."""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.harness import core, faults  # noqa: E402


def main(argv, device=None, hook=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--program-only", action="store_true",
                    help="the program's readings alone, no control")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = core.load_context(ROOT, args.workload, seed, args.seconds,
                                False, hook)
        ctx.device = core._device(ctx.cell["chips"], device)
        if ctx.device is None:
            return 3
        ctx.t_process = time.perf_counter()
        name = ctx.traffic["driver"]
        driver = importlib.import_module(f"benchmark.harness.drivers.{name}")
        if args.fault is None:
            r = core.control_readings(ctx, driver, not args.program_only)
        else:
            with faults.plant(args.fault, name):
                r = core.control_readings(ctx, driver, control=False)
            r["fault"] = args.fault
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
