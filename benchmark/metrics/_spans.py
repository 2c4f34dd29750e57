"""The program's own spans of the profiled requests, for the per-layer
metrics that read them.  ``isdf_torch.utils.obs`` records spans while
``torch.profiler`` records, so the last requests it kept are the profiled
window's: the last ``profiled_plans`` plans, or ``profiled_solves``
batched solves, as the records count them.  A program without the
recorder, or a window that profiled no such request, gives None."""

from __future__ import annotations

COUNT = {"plan": "profiled_plans", "batch.solve": "profiled_solves"}


def window(rec, root):
    """(the window's root spans named ``root``, every span of their
    requests), or None where the program kept none."""
    try:
        from isdf_torch.utils import obs
    except ImportError:
        return None
    read = getattr(obs, "spans", None)
    if read is None:
        return None
    n = rec.get(COUNT[root])
    if not n:
        return None
    spans = read()
    roots = sorted((s for s in spans if s.parent == 0 and s.name == root),
                   key=lambda s: s.start_ns)[-n:]
    if not roots:
        return None
    keep = {s.id for s in roots}
    return roots, [s for s in spans if s.request in keep]


def ms(s):
    return (s.end_ns - s.start_ns) * 1e-6


def durations(rec, root, name):
    """The ms of every span ``name`` in the window's ``root`` requests, or
    None where there is none."""
    got = window(rec, root)
    if got is None:
        return None
    d = [ms(s) for s in got[1] if s.name == name]
    return d or None


def mean_ms(rec, root, name):
    d = durations(rec, root, name)
    return None if d is None else sum(d) / len(d)


def within(spans, name, parents):
    """The spans ``name`` with an enclosing span named in ``parents``."""
    by_id = {s.id: s for s in spans}
    out = []
    for s in spans:
        if s.name != name:
            continue
        up = by_id.get(s.parent)
        while up is not None and up.name not in parents:
            up = by_id.get(up.parent)
        if up is not None:
            out.append(s)
    return out
