"""Observability: structured metrics stream and a run controller.

``Metrics`` and ``Controller`` are copied unchanged from
``isdf_tpu/utils/obs.py`` (they hold no JAX): metrics are appended to an
in-memory log with timestamps and optionally mirrored as JSON lines to a
file (the reference's debug_publisher topics,
src/utils/src/debug_publisher.cpp:11-33); the pause/stop/step affordance of
the reference's /debug_cmd opcodes 21/22 (plan_manager.cpp:502-585) is a
host-side Controller checked between chunks of a solve.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional


class Metrics:
    def __init__(self, jsonl_path: Optional[str] = None):
        self.records: List[Dict[str, Any]] = []
        self.jsonl_path = jsonl_path

    def log(self, key: str, value):
        self.log_dict({key: value})

    def log_dict(self, d: Dict[str, Any]):
        rec = {"ts": time.time()}
        for k, v in d.items():
            if hasattr(v, "tolist") and getattr(v, "size", 2) <= 64:
                v = v.tolist()
            elif hasattr(v, "shape") and getattr(v, "size", 0) > 64:
                continue  # don't serialize big arrays into the stream
            rec[k] = v
        self.records.append(rec)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec, default=str) + "\n")

    def latest(self, key: str, default=None):
        for rec in reversed(self.records):
            if key in rec:
                return rec[key]
        return default


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
