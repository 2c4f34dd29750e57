"""ctypes loader for the A* core in ``native/astar.cpp`` (the C++ twin of
the Python search loop in search/astar.py).

The library is compiled with the host C++ compiler at first use into
``isdf_torch/_build/``.  A* is a host algorithm in both packages: where no
compiler is present, ``astar_native`` returns None and the caller runs the
Python twin.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "astar.cpp"
BUILD_DIR = _PKG / "_build"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[Path]:
    cxx = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")
    if cxx is None or not SOURCE.exists():
        return None
    tag = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"astar_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [cxx, "-O3", "-std=c++17", "-fPIC", "-shared", "-o", tmp,
             str(SOURCE)], capture_output=True, timeout=300)
        if proc.returncode != 0:
            return None
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.isdf_astar_se3.restype = ctypes.c_int
    lib.isdf_astar_se3.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.POINTER(ctypes.c_long),
    ]
    _lib = lib
    return _lib


def astar_native(occ: np.ndarray, feas: Optional[np.ndarray], start_idx,
                 goal_idx, max_expansions: int = 2_000_000):
    """(path_idx (L,3), pose_idx (L,2), expanded), (None, None, expanded)
    when no path exists, or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    occ8 = np.ascontiguousarray(occ.astype(np.uint8))
    X, Y, Z = occ8.shape
    if feas is not None:
        feas8 = np.ascontiguousarray(feas.astype(np.uint8))
        R, P = feas8.shape[:2]
        fptr = feas8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    else:
        R = P = 0
        fptr = ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8))
    max_len = X * Y * Z
    out_path = np.zeros((max_len, 3), dtype=np.int32)
    out_poses = np.zeros((max_len, 2), dtype=np.int32)
    expanded = ctypes.c_long(0)
    L = lib.isdf_astar_se3(
        occ8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), X, Y, Z,
        fptr, R, P,
        int(start_idx[0]), int(start_idx[1]), int(start_idx[2]),
        int(goal_idx[0]), int(goal_idx[1]), int(goal_idx[2]),
        max_expansions,
        out_path.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        out_poses.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        max_len, ctypes.byref(expanded),
    )
    if L <= 0:
        return None if L < 0 else (None, None, expanded.value)
    return out_path[:L].copy(), out_poses[:L].copy(), expanded.value
