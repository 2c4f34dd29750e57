"""Observability: structured metrics stream.

``Metrics`` is copied unchanged from ``isdf_tpu/utils/obs.py`` (it holds no
JAX): metrics are appended to an in-memory log with timestamps and
optionally mirrored as JSON lines to a file (the reference's
debug_publisher topics, src/utils/src/debug_publisher.cpp:11-33).
"""

from __future__ import annotations

import json
import time
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
