"""Arithmetic the per-layer metrics share, over the records of a traced
run (``records`` of a driver's window: per-request host records, the
profiled span's summary and the sweep calls recorded in it)."""

from __future__ import annotations

from benchmark.frozen import flops


def _work(rec, call):
    label, B, need, P, N, coarse_n, rounds, cells = call
    if label.startswith("k3"):
        return flops.k3_work(cells[0], cells[1], B, need // B if B > 1
                             else need, N, coarse_n, rounds)
    body = rec["config"]["body"]["name"]
    posed = any(abs(v) > 0 for v in rec["config"]["settings"].get(
        "poly_params", ()))
    return flops.k1_work(body, posed, B, need // B if B > 1 else need, N,
                         coarse_n, rounds)


def roofline_pct(rec, labels, kernel):
    """The recorded calls' bound over the device time of the kernels whose
    name holds ``kernel``, in %: None where the trace shows none."""
    prof = rec.get("profile")
    calls = [c for c in rec.get("sweeps", []) if c[0] in labels]
    if not prof or not calls:
        return None
    ns = sum(v for k, v in prof["kernel_ns"].items() if kernel in k)
    if ns <= 0:
        return None
    bound = sum(flops.bound_s(*_work(rec, c)) for c in calls)
    return 100.0 * bound * 1e9 / ns


def idle_pct(rec):
    prof = rec.get("profile")
    if not prof:
        return None
    return 100.0 * (1.0 - prof["busy_ns"] / prof["window_ns"])


def per_plan_ms(rec, key):
    plans = rec.get("plans", [])
    if not plans:
        return None
    return 1e3 * sum(p[key] for p in plans) / len(plans)
