"""The benchmark's CPU tests run the harness through its test hook at tiny
sizes: the plain versions of the kernels, a few scenarios, a few
iterations."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the CPU rehearsal's sizes: the cells' shapes cut to what a test can run
SMALL = {"settings": {"sweep_coarse_samples": 64, "sweep_refine_rounds": 24,
                      "integralIntervs": 16, "max_obstacle_points": 256,
                      "max_iterations": 3},
         "traffic": {"B": 3, "P": 32, "max_iters": 8, "pool": 2, "check": 3,
                     "warm_iters": 2, "profiled": 1},
         # a solve of a few iterations on a few points ends farther from a
         # stationary point than the cells' solves: the gradient ratio reads
         # 0.03-0.47 here for sound runs and over 0.9 with the sweep's
         # gradient zeroed
         "limits": {"grad_ratio_q50": 0.7, "grad_ratio": 0.7}}


@pytest.fixture
def small():
    return {k: dict(v) for k, v in SMALL.items()}
