"""The lifecycle of the CUDA graphs that replay an optimizer stage's
cost-and-gradient evaluation: the mid end's (``opt/midend.py``) and the
back end's (``opt/backend.py``), one :class:`GraphCache` each.

A cache keeps the graphs of ``GRAPH_KEYS`` keys (what the evaluation's work
depends on besides the tensors' values), the least recently used first out.
A key's first ``WARMUP`` evaluations run eagerly; the next captures the
stage's graphs, and every later one, whichever solve it serves, replays
them.  A capture that raises leaves its key eager for good, its error on
the entry, counted in ``failures``, the random generators released.
``evals`` counts the evaluations by mode (``replay``, ``capture``,
``eager``), as the stages' ``graph`` span attribute names them.  On the CPU
a stage passes no entry: every evaluation is eager.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Optional

import torch

GRAPH_KEYS = 8           # keys whose graphs are kept, least recent first out
WARMUP = 2               # eager evaluations of a new key before its capture


def capture(graph, fn, pool=None):
    """fn() captured into ``graph``; the caller's stream comes back also
    where the capture raises."""
    stream = torch.cuda.current_stream()
    try:
        with torch.cuda.graph(graph, pool=pool):
            return fn()
    finally:
        torch.cuda.set_stream(stream)


def release_generators():
    """A capture that CUDA refused ends with the random generators still in
    capture mode (the next random draw on the card raises); one empty
    capture releases them."""
    with contextlib.suppress(Exception):
        capture(torch.cuda.CUDAGraph(), lambda: None)


def copy_in(static, args):
    """``args`` copied into a graph's static inputs ``static`` (None: made
    like args), which are returned; a None argument has none."""
    if static is None:
        static = [None if a is None else torch.empty_like(a) for a in args]
    for s, a in zip(static, args):
        if s is not None:
            s.copy_(a)
    return static


@dataclass
class Entry:
    """One key's state.  ``owner``, the stage's evaluation that made the
    entry, stays alive with it, and so does whatever the key names by id."""
    owner: Any
    graphs: Any = None
    seen: int = 0
    error: Optional[Exception] = None


class GraphCache:
    """One stage's entries by key and its counters; ``make(owner)`` makes a
    key's graphs, which capture on their first call and replay after."""

    def __init__(self, make):
        self.make = make
        self.entries: "OrderedDict[tuple, Entry]" = OrderedDict()
        self.evals = {"replay": 0, "capture": 0, "eager": 0}
        self.failures = 0        # keys whose capture raised

    def entry(self, key, owner) -> Entry:
        """The entry of ``key``, made for ``owner`` where it is new."""
        entry = self.entries.get(key)
        if entry is None:
            entry = self.entries[key] = Entry(owner)
            if len(self.entries) > GRAPH_KEYS:
                self.entries.popitem(last=False)
        else:
            self.entries.move_to_end(key)
        return entry

    def run(self, entry, args, eager):
        """(mode, answer) of one evaluation: ``entry``'s graphs on ``args``
        (mode "capture" the first time, "replay" after), or ``eager()``
        (mode "eager") where entry is None, in its warm-ups and after a
        failed capture."""
        mode = "eager"
        if entry is not None and entry.error is None \
                and entry.seen >= WARMUP:
            if entry.graphs is not None:
                mode, out = "replay", entry.graphs(*args)
            else:
                graphs = self.make(entry.owner)
                try:
                    mode, out = "capture", graphs(*args)
                    entry.graphs = graphs
                except Exception as exc:
                    mode, entry.error = "eager", exc
                    self.failures += 1
                    release_generators()
        elif entry is not None:
            entry.seen += 1
        if mode == "eager":
            out = eager()
        self.evals[mode] += 1
        return mode, out
