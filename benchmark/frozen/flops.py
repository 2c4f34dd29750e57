"""Operation and byte counts of the sweep kernels and the H100's peaks,
frozen here so that a change to the program cannot move the yardstick.

A copy of the counts of ``isdf_torch/utils/flops.py`` as they stood when the
benchmark was defined (read off ``csrc/sweep_warm.cu`` and
``csrc/grid_sweep.cu``: every FP32 add, sub, mul, div, sqrt, min, max and
abs one operation, an FMA two, compares and selects free).  The body SDF is
named by its zoo name instead of the program's kind id.  Only the tilt pose
map is kept: the benchmark's configurations fly the quadrotor.
"""

from __future__ import annotations

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

OPS_PVAJ = 3 + 3 * (10 + 8 + 6)      # local time + Horner pos/vel/acc, 3 axes
OPS_POSE = 50                        # quadrotor tilt -> R
OPS_REL = 18                         # R^T (p - x)
OPS_CAND = 4                         # t + w * off, clip to [0, total]
OPS_PLATEAU = 22                     # min, tie band, run mean, window shrink
OPS_POSED = 18                       # the config's pose of the body
OPS_SDF = {"Ball": 8, "RoundedCone": 12, "CappedCone": 49, "Torus": 12,
           "Cappedtorus": 17, "WireframeBox": 62, "BendLinear": 44,
           "TwistBox": 29, "BendBox": 29, "Table": 49, "Blobby": 83,
           "Trefoil": 47, "SmoothDifference": 41, "SmoothIntersection": 41,
           "CSG": 51, "Box": 20, "Point": 7}

# K3: grid coordinates, the clamped trilinear value, its gradient, the
# k = 4 plateau and the two warm pre-zoom rounds
OPS_COORD = 6
OPS_TRI = 12 + 3 + 21 + 12 + 5 + 4 + 1
OPS_TRI_GRAD = 33
OPS_PLATEAU4 = 13
K3_PRE = 2


def sdf_ops(body: str, posed: bool) -> int:
    return OPS_SDF[body] + (OPS_POSED if posed else 0)


def k1_ops_per_query(body: str, posed: bool, coarse_n: int, rounds: int,
                     k: int = 8) -> int:
    """K1's (and K2's) operations for one query point."""
    sdf = sdf_ops(body, posed)
    scan = coarse_n * (OPS_REL + sdf)
    zooms = 2 * rounds * (k * (OPS_CAND + OPS_PVAJ + OPS_POSE + OPS_REL + sdf)
                          + OPS_PLATEAU)
    epilogue = OPS_PVAJ + OPS_POSE + OPS_REL + 4 * sdf
    return scan + zooms + epilogue + 3


def k1_work(body: str, posed: bool, B: int, P: int, N: int, coarse_n: int,
            rounds: int):
    """(operations, bytes) of one K1 launch (B = 1) or K2 launch: each
    scenario's points, warm starts, pose table and piece tables read once,
    its t*, d* and gradient written once."""
    ops = B * P * k1_ops_per_query(body, posed, coarse_n, rounds)
    nbytes = B * (4 * (P * (3 + 1) + coarse_n * 12 + N * (2 + 18))
                  + 4 * P * 5)
    return ops, nbytes


def k3_ops(B: int, P: int, coarse_n: int, rounds: int, k: int = 4) -> int:
    """K3's operations for B scenarios of P queries: the coarse poses once
    per scenario and coarse time, the scan, the zooms and the epilogue per
    query."""
    pose = OPS_PVAJ + OPS_POSE + OPS_REL + OPS_COORD + OPS_TRI
    per_scenario = coarse_n * (3 + OPS_PVAJ + OPS_POSE)
    scan = coarse_n * (OPS_REL + OPS_COORD + OPS_TRI)
    zooms = (K3_PRE + rounds) * (k * (OPS_CAND + pose) + OPS_PLATEAU4)
    per_query = scan + zooms + pose + (pose + OPS_TRI_GRAD) + 3
    return B * (per_scenario + P * per_query)


def k3_work(field_cells: int, pooled_cells: int, B: int, P: int, N: int,
            coarse_n: int, rounds: int):
    """(operations, bytes) of one K3 launch: the field and its pooled twin
    read once, each scenario's inputs read and results written once."""
    ops = k3_ops(B, P, coarse_n, rounds)
    nbytes = (4 * (field_cells + pooled_cells)
              + B * (4 * (P * (3 + 1) + N * (2 + 18)) + 4 * P * 5))
    return ops, nbytes


def bound_s(ops: int, nbytes: int) -> float:
    """The least time the card could take: the larger of the operations
    over the FP32 (non-tensor) peak and the bytes over the memory rate."""
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)
