"""Observability: the span recorder and a run controller.

Spans time the program's own layers on the host: a plan's phases, each cost
evaluation and its parts, the line search's reads of device values, the
batched solver's loop trips.  The recorder records only while
``torch.profiler`` is recording (or inside :func:`tracing`); otherwise
:func:`span` costs a check of two module-level flags and returns a shared
no-op.  While recording, each span opens a profiler ``record_function`` of
its own name, so it shows on the device trace's timeline, and its times are
taken on that trace's clock (``time.time_ns``, the Unix epoch).  Closed
spans go to a bounded in-memory store that :func:`spans` reads, with the
times of their profiler events where it is given the finished profiler.

``Controller`` is copied unchanged from ``isdf_tpu/utils/obs.py``: the
pause/stop/step affordance of the reference's /debug_cmd opcodes 21/22
(plan_manager.cpp:502-585), checked on the host between chunks of a solve.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import List

import torch
from torch._C._autograd import _profiler_enabled
from torch.autograd import profiler as _profiler

CAPACITY = 1 << 17               # closed spans kept; the oldest go first

_forced = 0                      # open tracing() blocks
_store: deque = deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_local = threading.local()


class Span:
    """One timed interval: ``name``, ``start_ns``/``end_ns`` on the
    profiler's clock, ``id``, ``parent`` (the enclosing span's id, 0 for a
    root), ``request`` (the root's id, shared by every span of one plan or
    one batched solve) and ``attrs``, the counts set at close."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "request",
                 "attrs", "_rf", "_traced")

    def __init__(self, name: str):
        self.name = name
        self.attrs = {}

    def set(self, **attrs):
        self.attrs.update(attrs)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up is not None else 0
        self.request = up.request if up is not None else self.id
        stack.append(self)
        # whether a profiler records this thread (its flag is the process's)
        self._traced = _profiler_enabled()
        self._rf = torch._C._profiler._RecordFunctionFast(self.name)
        self._rf.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        self._rf.__exit__(*exc)
        self._rf = None
        _local.stack.pop()
        _store.append(self)
        return False


class _Off:
    """The span handed out while nothing records: no clock, no store."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


def recording() -> bool:
    return bool(_forced or _profiler._is_profiler_enabled)


def span(name: str):
    """A context manager timing its block as span ``name`` while recording;
    ``with span(...) as s: s.set(k=v)`` attaches counts at close."""
    if not (_forced or _profiler._is_profiler_enabled):
        return _OFF
    return Span(name)


def host_read(t, cast=float):
    """``cast(t)`` of a device value: the host waits for the device here,
    and while recording the wait is a ``host_read`` span."""
    if not (_forced or _profiler._is_profiler_enabled):
        return cast(t)
    with Span("host_read"):
        return cast(t)


@contextmanager
def tracing():
    """Record spans inside the block whether or not a profiler runs."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def spans(prof=None) -> List[Span]:
    """The closed spans kept, oldest first (a child closes before its
    parent).  With ``prof``, a finished ``torch.profiler.profile``, the n-th
    span of a name that it recorded takes the times of its n-th event of
    that name: span and event agree by construction."""
    kept = list(_store)
    if prof is None:
        return kept
    res = prof.profiler.kineto_results
    mine = sorted((s for s in kept                 # by name, as they opened
                   if s._traced and s.start_ns >= res.trace_start_ns()),
                  key=lambda s: (s.name, s.id))
    names = {s.name for s in mine}
    theirs = sorted((e.name(), e.start_ns(), e.end_ns())
                    for e in res.events() if e.name() in names)
    if [s.name for s in mine] != [name for name, _, _ in theirs]:
        raise ValueError("the spans a profiler recorded and its events of "
                         "their names differ")
    for s, (_, start, end) in zip(mine, theirs):
        s.start_ns, s.end_ns = start, end
    return kept


def clear():
    _store.clear()


@dataclass
class Controller:
    """Host-side pause/stop/step control between chunks of a solve (the
    reference's exit/pause/next_step flags, back_end_optimizer.hpp:116-118,
    driven by /debug_cmd opcodes)."""

    stop_requested: bool = False
    paused: bool = False
    _step_once: bool = False

    def stop(self):           # opcode 21
        self.stop_requested = True

    def toggle_pause(self):   # opcode 22
        self.paused = not self.paused

    def step(self):           # "next_step"
        self._step_once = True

    def should_continue(self) -> bool:
        if self.stop_requested:
            self.stop_requested = False
            return False
        while self.paused and not self._step_once:
            time.sleep(0.02)
        self._step_once = False
        return True
