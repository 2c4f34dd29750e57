"""One run of one cell of the port's benchmark, on the CUDA card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Loads and warms up the cell's configuration
and traffic, measures for ``--seconds``, checks the window's answers
against the plain reference, and prints one JSON line last.  Without a card
it exits with 3 and prints no result."""

import time

T_PROCESS = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_PROCESS, ROOT))
