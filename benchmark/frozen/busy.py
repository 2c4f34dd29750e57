"""The union of device intervals (a copy of ``isdf_torch/bench.py``'s
``busy_ns``), and the gaps between them."""

from __future__ import annotations


def busy_ns(spans) -> int:
    """Length of the union of (start, end) intervals."""
    busy, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def idle_gaps(spans, lo: int, hi: int):
    """The gaps of [lo, hi] that no interval covers, as (start, end)."""
    gaps, end = [], lo
    for a, b in sorted(spans):
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]
