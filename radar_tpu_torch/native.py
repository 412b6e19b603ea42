"""ctypes bindings of the native C++ host components — port of
``radar_tpu/native/__init__.py``: the track associator and the .bin
record reader and writer.

``csrc/tracker.cpp`` and ``csrc/binio.cpp`` (copies of
``radar_tpu/native/tracker.cpp`` and ``binio.cpp``) are compiled with the
host compiler at first use (``_build.load_host``), one library each. Where
the JAX package returns None and quietly runs numpy when its library is
missing, the port has no fallback: a failed build or load raises with the
compiler's message.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import _build

_D = ctypes.POINTER(ctypes.c_double)
_I64 = ctypes.POINTER(ctypes.c_int64)
_F = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "associate_tracks_5d": [_D, ctypes.c_int64, _D, _I64],
    "connected_components_gated": [_D, ctypes.c_int64, ctypes.c_int64, _D,
                                   _I64],
}
_BINIO_SIGNATURES = {
    "binio_probe": [ctypes.c_char_p, _I64, _I64, _I64, _I64],
    "binio_read": [ctypes.c_char_p, _F, _D, _D] + [ctypes.c_int64] * 3,
    "binio_write": [ctypes.c_char_p, _F, _D, _D] + [ctypes.c_int64] * 4
    + [ctypes.c_double] * 3,
}


def _load(name: str, signatures: dict) -> ctypes.CDLL:
    lib = _build.load_host(name)
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int64
    return lib


def load_library() -> ctypes.CDLL:
    """The tracker library, built on first use."""
    return _load("tracker", _SIGNATURES)


def load_binio() -> ctypes.CDLL:
    """The .bin reader/writer library, built on first use."""
    return _load("binio", _BINIO_SIGNATURES)


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


def binio_probe_native(path: str) -> tuple:
    """(n_prt, n_samples, n_channels, freq_no) of a .bin file; IOError on
    a malformed file."""
    dims = [ctypes.c_int64(0) for _ in range(4)]
    rc = load_binio().binio_probe(path.encode(),
                                  *[ctypes.byref(d) for d in dims])
    if rc != 0:
        raise IOError(f"binio_probe({path}) failed with code {rc}")
    return tuple(d.value for d in dims)


def binio_read_native(path: str, iq, realtime, servo) -> None:
    """Read every record into caller buffers, C-contiguous CPU tensors:
    ``iq`` float32 [n_prt, n_samples, n_channels, 2] (I, Q descaled),
    ``realtime`` float64 [n_prt, 16], ``servo`` float64 [n_prt], their
    shapes those of ``binio_probe_native``. IOError on a malformed file."""
    import torch

    n_prt, n_samples, n_channels = (int(d) for d in iq.shape[:3])
    for t, shape, dtype in ((iq, (n_prt, n_samples, n_channels, 2),
                             torch.float32),
                            (realtime, (n_prt, 16), torch.float64),
                            (servo, (n_prt,), torch.float64)):
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device.type != "cpu" or not t.is_contiguous()):
            raise ValueError("binio_read_native: a buffer's shape, dtype, "
                             "device or layout is wrong")
    ptr = lambda t, c: ctypes.cast(t.data_ptr(), ctypes.POINTER(c))
    rc = load_binio().binio_read(
        path.encode(), ptr(iq, ctypes.c_float), ptr(realtime, ctypes.c_double),
        ptr(servo, ctypes.c_double), n_prt, n_samples, n_channels)
    if rc != 0:
        raise IOError(f"binio_read({path}) failed with code {rc}")


def binio_write_native(path: str, iq: np.ndarray, realtime: np.ndarray,
                       servo: np.ndarray, freq_no: int, fs_hz: float,
                       prt_s: float, iq_scale: float) -> None:
    """Write PRT records of ``iq`` complex [n_prt, n_samples, n_channels];
    IOError if the file cannot be written."""
    n_prt, n_samples, n_channels = iq.shape
    buf = np.ascontiguousarray(iq, np.complex64).view(np.float32)  # I, Q
    realtime = np.ascontiguousarray(realtime, np.float64)
    servo = np.ascontiguousarray(servo, np.float64)
    rc = load_binio().binio_write(
        path.encode(), buf.ctypes.data_as(_F), realtime.ctypes.data_as(_D),
        servo.ctypes.data_as(_D), n_prt, n_samples, n_channels, freq_no,
        fs_hz, prt_s, iq_scale)
    if rc != 0:
        raise IOError(f"binio_write({path}) failed with code {rc}")
