"""The traced run's instruments, kept outside the program: a recorder of
the sweep kernels' arguments, and a summary of a torch.profiler trace held
in memory (no trace file is written)."""

from __future__ import annotations

import contextlib
from collections import defaultdict

from benchmark.frozen.busy import busy_ns, idle_gaps

WINDOW = "bench.window"          # the profiled span's record_function
PROFILER_OWN = ("Activity Buffer",)   # the profiler's own host events
TOP = 10
REACH = 1e5                      # metres: farther obstacle slots are padding


class SweepRecorder:
    """Wraps the sweep kernels' entry points on the attributes that
    ``isdf_torch/sweep/sweep_sdf.py`` looks up at each call, and records each
    call's shape: scenarios, points the inputs need (within ``REACH`` of
    the origin: the program pads obstacle slots far away), pieces, coarse
    samples, rounds and, for the grid kernel, the field's cells.  The counts
    stay on the device until :meth:`calls`."""

    ENTRIES = (("isdf_torch.sweep.fused_zoom", "sweep_warm_fused", "k1"),
               ("isdf_torch.sweep.fused_zoom", "sweep_warm_fused_batched",
                "k2"),
               ("isdf_torch.sweep.grid_zoom", "grid_sweep_warm_fused", "k3"),
               ("isdf_torch.sweep.grid_zoom", "grid_sweep_warm_fused_batched",
                "k3b"))

    def __init__(self):
        self.raw = []

    def _wrap(self, fn, label):
        def rec(*args, **kw):
            pts = args[2] if len(args) > 2 else kw.get("pts")
            coeffs = kw.get("coeffs", args[-1])
            grid = args[0]
            need = ((pts.abs() < REACH).all(-1)).sum()
            cells = None
            if label.startswith("k3"):
                cells = (grid.field.numel(), grid.pooled.numel())
            B = pts.shape[0] if pts.dim() == 3 else 1
            self.raw.append((label, B, need, pts.shape[-2],
                             coeffs.shape[-3], kw.get("coarse_n"),
                             kw.get("rounds"), cells))
            return fn(*args, **kw)
        return rec

    @contextlib.contextmanager
    def active(self):
        import importlib
        saved = []
        try:
            for mod_name, attr, label in self.ENTRIES:
                mod = importlib.import_module(mod_name)
                fn = getattr(mod, attr, None)
                if fn is None:
                    continue
                saved.append((mod, attr, fn))
                setattr(mod, attr, self._wrap(fn, label))
            yield self
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)

    def calls(self):
        """[(label, B, points needed, P, N, coarse_n, rounds, cells)]."""
        return [(lab, B, int(need), P, N, cn, r, cells)
                for lab, B, need, P, N, cn, r, cells in self.raw
                if cn is not None and r is not None]


def summarize(prof) -> dict:
    """The profiled span's device time: its length, the union of the
    device's intervals, device time by kernel name, the operations that
    took most time and the longest idle gaps with the host operation that
    was running in each."""
    import numpy as np
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev_spans, hs, he, hn = [], [], [], []
    lo = hi = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if name != WINDOW:        # the span's own mark on the timeline
                dev_spans.append((e.start_ns(), e.end_ns(), name))
        elif name == WINDOW:
            lo, hi = e.start_ns(), e.end_ns()
        elif not name.startswith(PROFILER_OWN):
            hs.append(e.start_ns())
            he.append(e.end_ns())
            hn.append(name)
    if lo is None or not dev_spans:
        return {}
    spans, by_name = [], defaultdict(int)
    for a, b, n in dev_spans:
        if b > lo and a < hi:
            a, b = max(a, lo), min(b, hi)
            spans.append((a, b))
            by_name[n] += b - a
    gaps = sorted(idle_gaps(spans, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    order = np.argsort(np.asarray(hs, dtype=np.int64), kind="stable")
    hs = np.asarray(hs, dtype=np.int64)[order]
    he = np.asarray(he, dtype=np.int64)[order]
    named = []
    for a, b in gaps:
        mid = (a + b) // 2
        # the innermost host operation open at the gap's middle: the last
        # to start of those that started before it and end after it
        k = int(np.searchsorted(hs, mid, side="right"))
        open_ = np.nonzero(he[:k] >= mid)[0]
        inner = hn[order[open_[-1]]] if len(open_) else None
        named.append([inner or "(no host operation)", (b - a) * 1e-9])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_ns": hi - lo, "busy_ns": busy_ns(spans),
            "kernel_ns": dict(by_name), "device_events": len(spans),
            "breakdown": {"device_ops": [[n, v * 1e-9] for n, v in top],
                          "idle_gaps": named}}


@contextlib.contextmanager
def profiled(records: dict):
    """torch.profiler over the block, summarised into ``records``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    summary = summarize(prof)
    if summary:
        records["breakdown"] = summary.pop("breakdown")
        records["profile"] = summary
