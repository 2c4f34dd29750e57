"""Device time outside the sweep kernel in the profiled solve (the
lockstep's small kernels: MINCO, the feasibility integral, L-BFGS), in ms a
solve."""

KERNELS = ("sweep_warm_kernel", "grid_sweep_kernel")


def read(rec):
    prof = rec.get("profile")
    if not prof:
        return None
    sweep = sum(v for k, v in prof["kernel_ns"].items()
                if any(n in k for n in KERNELS))
    return 1e-6 * (prof["busy_ns"] - sweep) / rec["profiled_solves"]
