"""ctypes loader for the native C++ core (counterpart of
``isdf_tpu/native.py``): A* in ``native/astar.cpp`` and marching tetrahedra
in ``native/marching_cubes.cpp``.

Both sources are compiled into one library with the host C++ compiler at
first use, into ``isdf_torch/_build/``, named by the sources' hash; nothing
is written into ``native/``.  Both are host algorithms in both packages:
where no compiler is present, ``get_lib`` returns None, ``astar_native``
and ``marching_tetrahedra`` return None, and the caller runs its Python
twin (search/astar.py, viz/swept_mesh.py).
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

_PKG = Path(__file__).resolve().parent
SOURCES = (_PKG.parent / "native" / "astar.cpp",
           _PKG.parent / "native" / "marching_cubes.cpp")
BUILD_DIR = _PKG / "_build"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[Path]:
    cxx = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")
    if cxx is None or not all(s.exists() for s in SOURCES):
        return None
    h = hashlib.sha1()
    for s in SOURCES:
        h.update(s.read_bytes())
    out = BUILD_DIR / f"native_{h.hexdigest()[:12]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [cxx, "-O3", "-std=c++17", "-fPIC", "-shared", "-o", tmp,
             *map(str, SOURCES)], capture_output=True, timeout=300)
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
    lib.isdf_marching_tetrahedra.restype = ctypes.c_long
    lib.isdf_marching_tetrahedra.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.POINTER(ctypes.c_double), ctypes.c_long,
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


def marching_tetrahedra(field: np.ndarray, origin, resolution: float,
                        iso: float = 0.0) -> Optional[np.ndarray]:
    """Triangle soup (T, 3, 3) of the iso-surface of a float64 (X, Y, Z)
    field on the grid origin + resolution·index, or None if the library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    f = np.ascontiguousarray(field.astype(np.float64))
    X, Y, Z = f.shape
    max_tris = max(4 * X * Y * Z, 1 << 16)
    out = np.zeros((max_tris, 9), dtype=np.float64)
    n = lib.isdf_marching_tetrahedra(
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), X, Y, Z,
        float(origin[0]), float(origin[1]), float(origin[2]),
        float(resolution), float(iso),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_tris,
    )
    if n < 0:
        return None
    return out[:n].reshape(n, 3, 3)
