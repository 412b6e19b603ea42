"""ctypes bindings of the native C++ track associator — port of
``radar_tpu/native/__init__.py:17-108`` (the tracker's half; the .bin
reader is not ported).

``csrc/tracker.cpp`` (a copy of ``radar_tpu/native/tracker.cpp``) is
compiled with the host compiler at first use (``_build.load_host``). Where
the JAX package returns None and quietly runs the numpy BFS when its
library is missing, the port has no fallback: a failed build or load
raises with the compiler's message.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import _build

_D = ctypes.POINTER(ctypes.c_double)
_I64 = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "associate_tracks_5d": [_D, ctypes.c_int64, _D, _I64],
    "connected_components_gated": [_D, ctypes.c_int64, ctypes.c_int64, _D,
                                   _I64],
}


def load_library() -> ctypes.CDLL:
    """The tracker library, built on first use."""
    lib = _build.load_host("tracker")
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int64
    return lib


def _fields(columns) -> np.ndarray:
    return np.ascontiguousarray(
        np.stack([np.asarray(c, np.float64) for c in columns]))


def associate_tracks_5d_native(range_m, velocity_ms, azimuth_deg,
                               elevation_deg, frame, gates) -> np.ndarray:
    """Component ids [n] (first-seen order) of the 5D gated BFS; ``gates``
    = (r, v, az, el, frame)."""
    lib = load_library()
    n = len(range_m)
    fields = _fields([range_m, velocity_ms, azimuth_deg, elevation_deg,
                      frame])
    g = np.ascontiguousarray(np.asarray(gates, np.float64))
    if g.shape != (5,):
        raise ValueError(f"gates takes 5 values, got {g.shape}")
    out = np.empty(n, np.int64)
    lib.associate_tracks_5d(fields.ctypes.data_as(_D), n,
                            g.ctypes.data_as(_D), out.ctypes.data_as(_I64))
    return out


def connected_components_gated_native(fields_list, gates) -> np.ndarray:
    """Dense gated BFS over k fields of equal length: component ids [n]."""
    lib = load_library()
    fields = _fields(fields_list)
    k, n = fields.shape
    g = np.ascontiguousarray(np.asarray(gates, np.float64))
    if g.shape != (k,):
        raise ValueError(f"gates takes {k} values, got {g.shape}")
    out = np.empty(n, np.int64)
    lib.connected_components_gated(fields.ctypes.data_as(_D), n, k,
                                   g.ctypes.data_as(_D),
                                   out.ctypes.data_as(_I64))
    return out
