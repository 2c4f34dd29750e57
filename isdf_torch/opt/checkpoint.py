"""Optimizer-state checkpoint / resume (counterpart of
``isdf_tpu/opt/checkpoint.py``, host numpy).

The reference has none; its only persistence is the two warm-start channels
(mid-end opt_x → back end, per-point lastTstar).  A checkpoint holds the
decision vector x, the swept-SDF t* warm starts and a hash of the problem
definition, as a .npz: enough to resume an interrupted solve or replay it on
another host.  The file and the hash are the JAX package's, so either
package reads the other's checkpoints, and equal configs give equal
fingerprints.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Optional

import numpy as np


def _host(a) -> np.ndarray:
    """An array or tensor (on any device) as a host numpy array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def problem_fingerprint(conf, N: int, n_points: int) -> str:
    payload = json.dumps(
        {"conf": sorted((k, str(v)) for k, v in conf.__dict__.items()),
         "N": N, "P": n_points},
        sort_keys=True,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def save(path: str, x, t_star, conf, extra: Optional[Dict[str, Any]] = None):
    t_star = _host(t_star)
    np.savez(
        path,
        x=_host(x),
        t_star=t_star,
        fingerprint=problem_fingerprint(conf, 0, len(t_star)),
        **{k: _host(v) for k, v in (extra or {}).items()},
    )


def load(path: str, conf=None):
    """→ (x, t_star, fingerprint), host numpy."""
    data = np.load(path, allow_pickle=False)
    return data["x"], data["t_star"], str(data["fingerprint"])
