"""ctypes binding of the native exact-hypervolume sweep (``hv.cpp``,
C ABI ``deap_tpu_hv``).  :func:`load` builds the library at first use
and returns ``None`` when that is not possible, which
:func:`deap_tpu_torch.ops.hv.hypervolume` treats as "use the numpy
WFG"."""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from .build import build

__all__ = ["load", "hypervolume"]

_lib = None
_tried = False
_lock = threading.Lock()


def load():
    """The bound library, or ``None`` when it cannot be built or
    loaded.  Tried once per process."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            path = build()
            if path is not None:
                try:
                    lib = ctypes.CDLL(str(path))
                except OSError:
                    lib = None
                if lib is not None:
                    lib.deap_tpu_hv.restype = ctypes.c_double
                    lib.deap_tpu_hv.argtypes = [
                        ctypes.POINTER(ctypes.c_double), ctypes.c_long,
                        ctypes.c_long, ctypes.POINTER(ctypes.c_double)]
                _lib = lib
    return _lib


def hypervolume(pointset, ref) -> float:
    """Exact hypervolume (minimization) of ``pointset`` ``(n, d)`` with
    respect to ``ref``; every point must lie strictly below ``ref``."""
    lib = load()
    if lib is None:
        raise RuntimeError("native hypervolume library unavailable")
    pts = np.ascontiguousarray(pointset, np.float64)
    r = np.ascontiguousarray(ref, np.float64)
    if pts.ndim == 1:
        pts = pts.reshape(1, -1)
    elif pts.ndim != 2:
        pts = pts.reshape(-1, pts.shape[-1])
    n, d = pts.shape
    if r.shape != (d,):
        raise ValueError("reference point dimension mismatch")
    return float(lib.deap_tpu_hv(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_long(n), ctypes.c_long(d),
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_double))))
