"""Operation and byte counts of the sweep kernels on the card, and the
bound they give (the least time the card could take for the same work).

This replaces the JAX package's ``utils/flops.py`` (a jaxpr walk that
counts the XLA program's elementwise operations, for the TPU's VPU
roofline in bench.py): a CUDA kernel has no jaxpr, so the counts are read
off the CUDA sources by hand, per query point, and the bound is taken
against the H100's published FP32 (non-tensor) peak and memory rate.
``chip_smoke.py`` reports every kernel case's ``bound_ms`` from here.
"""

from __future__ import annotations

from isdf_torch.core.flatness import PlanarPose

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# K1 operation count, per query point, read off isdf_torch/csrc/sweep_warm.cu:
# every FP32 add/sub/mul/div/sqrt/rsqrt/min/max/abs is one operation (an FMA
# two), compares and selects are free.
OPS_PVAJ = 3 + 3 * (10 + 8 + 6)      # local time + Horner pos/vel/acc, 3 axes
OPS_POSE = 50                        # quadrotor tilt → R (pose_at)
OPS_REL = 18                         # Rᵀ(p − x)
OPS_CAND = 4                         # t + w·off, clip to [0, total]
OPS_PLATEAU = 22                     # min, tie band, run mean, window shrink
OPS_POSED = 18                       # poly_params pose transform
# body SDFs by kind id (isdf_torch/shapes/spec.py), counted from the device
# functions; where a function branches, its cheapest branch (a lower bound);
# cos, sin, atan2, floor and sqrt count one each
OPS_SDF = {
    1: 8,     # Ball: n3 (3 mul, 3 add, sqrt) + sub
    2: 12,    # RoundedCone
    3: 49,    # CappedCone
    4: 12,    # Torus: two n2 (5) + 2 sub
    5: 17,    # Cappedtorus: abs, 2 compare products, 3 (linear branch), psq 5,
              #   6 for the root
    6: 62,    # WireframeBox: 18 for ps/q, 3 × 14 for g, 2 min
    7: 44,    # BendLinear: t 11, ease 2 (first branch), shift 6, capsule 25
    8: 29,    # TwistBox: k·z, cos, sin, rotation 6, box 20
    9: 29,    # BendBox
    10: 49,   # Table: 2 abs, 6 sub, 2 boxes, min
    11: 83,   # Blobby: 4 balls (11) + 3 smooth unions (13)
    12: 47,   # Trefoil
    13: 41,   # SmoothDifference/SmoothIntersection: box 20, ball 8, blend 13
    14: 51,   # CSG: ball 8, box 20, 3 cylinders (6), 2 min, 2 max, neg
    15: 20,   # Box
    16: 7,    # Point
}


# The planar (SE(2)) chain of pose_chain.cuh's pose_at(PlanarArgs): the local
# time (3) and the position Horner of the three axes alone (10 each, no
# velocity or acceleration); the pose is x = (p0, p1, z_ref) and R = Rz(p2):
# cos and sin count one operation each, as in OPS_SDF, and −sin one more;
# Rᵀ(p − x) without Rz's zeros and ones: 3 differences, 2 × (2 products + 1
# sum), the z row a copy.
OPS_PVAJ_PLANAR = 3 + 3 * 10
OPS_POSE_PLANAR = 3
OPS_REL_PLANAR = 3 + 2 * 3


def chain_ops(planar: bool):
    """(pvaj, pose, rel) operations of one pose-chain evaluation under the
    planar or the tilt map."""
    if planar:
        return OPS_PVAJ_PLANAR, OPS_POSE_PLANAR, OPS_REL_PLANAR
    return OPS_PVAJ, OPS_POSE, OPS_REL


def is_planar(params) -> bool:
    return isinstance(params, PlanarPose)


def sdf_ops(shape) -> int:
    return OPS_SDF[shape.spec.kind] + (OPS_POSED if shape.spec.posed else 0)


def k1_ops_per_query(shape, coarse_n: int, rounds: int, k: int = 8,
                     planar: bool = False) -> int:
    pvaj, pose, rel = chain_ops(planar)
    sdf = sdf_ops(shape)
    scan = coarse_n * (rel + sdf)
    zooms = 2 * rounds * (k * (OPS_CAND + pvaj + pose + rel + sdf)
                          + OPS_PLATEAU)
    epilogue = pvaj + pose + rel + 4 * sdf      # dual: value + 3
    return scan + zooms + epilogue + 3


def k4_ops_per_query(shape, rounds: int, k: int = 8,
                     planar: bool = False) -> int:
    pvaj, pose, rel = chain_ops(planar)
    return rounds * (k * (OPS_CAND + pvaj + pose + rel + sdf_ops(shape))
                     + OPS_PLATEAU)


def bound_ms(ops: int, nbytes: int):
    """(bound ms, "operations" or "bytes", ops, bytes): the larger of the
    FP32 work over the FP32 non-tensor peak and the bytes (each input read
    once, each output written once) over the memory rate."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


def k1_bound_ms(shape, P: int, N: int, coarse_n: int, rounds: int,
                B: int = 1, planar: bool = False):
    """K1's bound, and K2's with B scenarios: the same work per query, and
    every scenario's own pose table and piece tables read once."""
    ops = B * P * k1_ops_per_query(shape, coarse_n, rounds, planar=planar)
    nbytes = B * (4 * (P * (3 + 1) + coarse_n * 12 + N * (2 + 18))
                  + 4 * P * 5)
    return bound_ms(ops, nbytes)


def k4_bound_ms(shape, P: int, N: int, rounds: int, planar: bool = False):
    return bound_ms(P * k4_ops_per_query(shape, rounds, planar=planar),
                    4 * (P * (3 + 2) + N * (2 + 18)) + 4 * P)


# K3 operation count, per query point, read off isdf_torch/csrc/grid_sweep.cu
# the same way: a trilinear evaluation is grid coordinates (6), the clamp,
# corner index and fraction per axis (12), 3 weights and 7 lerps (24), the
# outside term (over 12, squares 5, root 4) and the sum (1)
OPS_COORD = 6
OPS_TRI = 12 + 3 + 21 + 12 + 5 + 4 + 1
OPS_TRI_GRAD = 33        # corner differences, lerps, masks, slope, 3 × 4
OPS_PLATEAU4 = 13        # k = 4: min 3, tie band 4, run mean 5, shrink 1
K3_PRE = 2               # warm pre-zoom rounds


def k3_ops(B: int, P: int, coarse_n: int, rounds: int, k: int = 4,
           planar: bool = False) -> int:
    """K3's operations for B scenarios of P queries.  The coarse poses are a
    function of the time alone: once per scenario and coarse time (the
    clipped time j·step, the piece's pos/vel/acc and the tilt, or the
    planar chain), as the plain version computes them; per query and coarse
    time p_rel and the pooled trilinear value."""
    pvaj, rot, rel = chain_ops(planar)
    pose = pvaj + rot + rel + OPS_COORD + OPS_TRI
    per_scenario = coarse_n * (3 + pvaj + rot)
    scan = coarse_n * (rel + OPS_COORD + OPS_TRI)
    zooms = (K3_PRE + rounds) * (k * (OPS_CAND + pose) + OPS_PLATEAU4)
    per_query = scan + zooms + pose + (pose + OPS_TRI_GRAD) + 3
    return B * (per_scenario + P * per_query)


def k3_bound_ms(grid, P: int, N: int, coarse_n: int, rounds: int,
                B: int = 1, planar: bool = False):
    """K3's bound: the operations of :func:`k3_ops`; the bytes of the field
    and its pooled twin read once and of every scenario's points, warm
    starts, piece tables and results."""
    ops = k3_ops(B, P, coarse_n, rounds, planar=planar)
    nbytes = (4 * (grid.field.numel() + grid.pooled.numel())
              + B * (4 * (P * (3 + 1) + N * (2 + 18)) + 4 * P * 5))
    return bound_ms(ops, nbytes)


# K5 operation count, per time, read off isdf_torch/csrc/pieces.cu the same
# way.  Forward: the clip and local time (3) and the Horner chains of pos
# (10), vel (12) and acc (10, their coefficients folded in the kernel) of 3
# axes.  Backward: the clip again (3), s's powers (4), per axis the 18
# coefficient rows (29) and the derivative in s (jerk 7, vel 12, acc 10,
# their sum 6), the clip's split (3) and the per-piece sum of 20 values.
OPS_K5_FORWARD = 3 + 3 * (10 + 12 + 10)
OPS_K5_BACKWARD = 3 + 4 + 3 * (29 + 35) + 3 + 20


def k5_bound_ms(B: int, M: int, N: int, itemsize: int = 4,
                want_t: bool = False):
    """K5's bound, forward and backward, for B trajectories of N pieces at
    M times each: every time's t and nine components moved once each way
    (t's gradient too where it is wanted), every trajectory's tables (start,
    duration, end, 18 coefficients) read once a pass and their gradient (20
    values a piece) written once; the per-tile partials stay in L2."""
    ops = B * M * (OPS_K5_FORWARD + OPS_K5_BACKWARD)
    nbytes = itemsize * (B * M * (10 + 10 + int(want_t))
                         + B * N * (21 + 21 + 20))
    return bound_ms(ops, nbytes)
