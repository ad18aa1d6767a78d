"""Native (C++) eval helpers with a lazy build and ctypes bindings
(counterpart of m3vit_tpu/native/__init__.py).

``edge_ops.cpp`` (Zhang-Suen thinning and greedy boundary correspondence)
is compiled with ``g++ -O3 -shared -fPIC`` at first use into
``m3vit_tpu_torch/_build/native_<hash>/``, where the hash covers the source
and the flags; nothing is built at import.  The Python implementations
(``data.pascal_context.zhang_suen_thin``,
``evaluation.edge_eval._match_counts``) are the behavioural reference, and
the callers use them when no C++ toolchain is there (each function here
then returns None).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "edge_ops.cpp"
_BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + _SRC.read_bytes())
    return _BUILD_ROOT / f"native_{h.hexdigest()[:16]}" / "edge_ops.so"


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            path = lib_path()
            if not path.exists():
                path.parent.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".so.tmp{os.getpid()}")
                subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                               check=True, capture_output=True)
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.CalledProcessError):
            _build_failed = True
            return None
        lib.zhang_suen_thin.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.match_boundaries.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return lib


def native_available() -> bool:
    return _load() is not None


def thin(img: np.ndarray, max_iter: int = 10000) -> Optional[np.ndarray]:
    """Native Zhang-Suen thinning; None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    buf = np.ascontiguousarray((img > 0).astype(np.uint8))
    h, w = buf.shape
    lib.zhang_suen_thin(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, max_iter)
    return buf


def match_boundaries(pred: np.ndarray, gt: np.ndarray, max_dist: float
                     ) -> Optional[Tuple[int, int, int, int]]:
    """Native greedy correspondence: (matched_pred, n_pred, matched_gt,
    n_gt) like edge_eval._match_counts, or None when the library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    p = np.ascontiguousarray((pred > 0).astype(np.uint8))
    g = np.ascontiguousarray((gt > 0).astype(np.uint8))
    h, w = p.shape
    matched, n_pred, n_gt = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    lib.match_boundaries(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        g.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, float(max_dist),
        ctypes.byref(matched), ctypes.byref(n_pred), ctypes.byref(n_gt))
    return matched.value, n_pred.value, matched.value, n_gt.value
