"""Binary PRT-record frame files (.bin), the real-data wire format — port
of ``radar_tpu/io/binio.py``.

The reference's real-data adapter declares the per-PRT framing byte counts
(main_test_with_simulated_data.m:58-60: bytesFrameHead=64,
bytesFrameRealtime=128, bytesFrameEnd=64) and a ``save_to_bin`` switch
(main_test:35), but every reader and writer is missing from its repository
(SURVEY.md section 2.4). The reference package defines a little-endian
record format around those byte counts, kept here byte for byte:

  one PRT record = 64-byte head | int16 I/Q payload | 128-byte realtime
                   block (16 float64) | 64-byte end

Head fields (packed little-endian): magic "RDPH", version=1(u32),
prt_index(u32), n_samples(u32), n_channels(u32), freq_no(u32), fs_hz(f64),
prt_s(f64), servo_angle_deg(f64), iq_scale(f64), payload_bytes(u32),
4 reserved bytes. Payload: [n_samples, n_channels] with channel fastest,
int16 I then int16 Q per element, value = round(x / iq_scale) clipped to
int16. End: magic "RDPE"(u32), additive payload byte checksum(u32),
record_bytes(u64), 48 reserved bytes. A file is a plain concatenation of
records; a frame of prtNum PRTs is prtNum consecutive records.

``use_native=True`` (the default) runs the C++ reader and writer of
``csrc/binio.cpp`` and raises if that library cannot be built or loaded;
``use_native=False`` is the numpy implementation below. Each reads the
other's files; they write the same bytes at an explicit ``iq_scale`` (at
the default scale the C++ multiplies by the f64 reciprocal where numpy
divides in f32, as in the reference package). The readers return tensors on
``device`` (the card by default); the native reader fills a pinned host
buffer that goes to the card in one copy.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import native

HEAD_MAGIC = 0x48504452  # "RDPH"
END_MAGIC = 0x45504452   # "RDPE"
HEAD_BYTES = 64
REALTIME_BYTES = 128
END_BYTES = 64

_HEAD_DTYPE = np.dtype([
    ("magic", "<u4"), ("version", "<u4"), ("prt_index", "<u4"),
    ("n_samples", "<u4"), ("n_channels", "<u4"), ("freq_no", "<u4"),
    ("fs_hz", "<f8"), ("prt_s", "<f8"), ("servo_angle_deg", "<f8"),
    ("iq_scale", "<f8"), ("payload_bytes", "<u4"), ("reserved", "V4")])
_END_DTYPE = np.dtype([
    ("magic", "<u4"), ("checksum", "<u4"), ("record_bytes", "<u8"),
    ("reserved", "V48")])
if _HEAD_DTYPE.itemsize != HEAD_BYTES or _END_DTYPE.itemsize != END_BYTES:
    raise ImportError("binio record layout does not match its byte counts")


@dataclass(frozen=True)
class BinFrameMeta:
    """Per-file metadata recovered from the record heads."""
    n_prt: int
    n_samples: int
    n_channels: int
    freq_no: int
    fs_hz: float
    prt_s: float


def _record_bytes(n_samples: int, n_channels: int) -> int:
    return (HEAD_BYTES + n_samples * n_channels * 4 + REALTIME_BYTES
            + END_BYTES)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def default_iq_scale(iq) -> float:
    """Full-scale quantization step: the peak rail amplitude lands on
    +/-30000 counts (headroom below int16 full scale)."""
    iq = _host(iq)
    peak = float(max(np.abs(iq.real).max(), np.abs(iq.imag).max(), 1e-30))
    return peak / 30000.0


def write_bin(path: str, iq, servo_angle_deg, freq_no: int = 0,
              fs_hz: float = 25e6, prt_s: float = 232.76e-6,
              realtime: np.ndarray | None = None,
              iq_scale: float | None = None, use_native: bool = True
              ) -> BinFrameMeta:
    """Write ``iq`` [n_prt, n_samples, n_channels] complex (array or
    tensor) as PRT records. ``servo_angle_deg`` is scalar or per-PRT;
    ``realtime`` is an optional [n_prt, 16] float64 block carried
    opaquely. Returns the file metadata."""
    iq = _host(iq)
    if iq.ndim != 3:
        raise ValueError(f"iq must be [n_prt, n_samples, n_channels], "
                         f"got shape {iq.shape}")
    n_prt, n_samples, n_channels = iq.shape
    servo = np.broadcast_to(
        np.asarray(servo_angle_deg, np.float64), (n_prt,)).copy()
    if realtime is None:
        realtime = np.zeros((n_prt, REALTIME_BYTES // 8), np.float64)
    realtime = np.ascontiguousarray(realtime, np.float64)
    if realtime.shape != (n_prt, REALTIME_BYTES // 8):
        raise ValueError(f"realtime must be [{n_prt}, 16], "
                         f"got {realtime.shape}")
    if iq_scale is None:
        iq_scale = default_iq_scale(iq)
    meta = BinFrameMeta(n_prt, n_samples, n_channels, int(freq_no),
                        float(fs_hz), float(prt_s))
    if use_native:
        native.binio_write_native(path, iq, realtime, servo, int(freq_no),
                                  float(fs_hz), float(prt_s),
                                  float(iq_scale))
        return meta

    inter = np.empty((n_prt, n_samples, n_channels, 2), np.float32)
    inter[..., 0] = iq.real
    inter[..., 1] = iq.imag
    quant = np.clip(np.rint(inter / np.float32(iq_scale)),
                    -32768, 32767).astype("<i2")
    head = np.zeros(1, _HEAD_DTYPE)
    head["magic"], head["version"] = HEAD_MAGIC, 1
    head["n_samples"], head["n_channels"] = n_samples, n_channels
    head["freq_no"] = int(freq_no)
    head["fs_hz"], head["prt_s"] = fs_hz, prt_s
    head["iq_scale"] = iq_scale
    head["payload_bytes"] = n_samples * n_channels * 4
    end = np.zeros(1, _END_DTYPE)
    end["magic"] = END_MAGIC
    end["record_bytes"] = _record_bytes(n_samples, n_channels)
    with open(path, "wb") as f:
        for m in range(n_prt):
            head["prt_index"] = m
            head["servo_angle_deg"] = servo[m]
            payload = quant[m].tobytes()
            end["checksum"] = np.uint32(
                np.frombuffer(payload, np.uint8).sum(dtype=np.uint64)
                & 0xFFFFFFFF)
            f.write(head.tobytes())
            f.write(payload)
            f.write(realtime[m].astype("<f8").tobytes())
            f.write(end.tobytes())
    return meta


def _read_head(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        head = np.frombuffer(f.read(HEAD_BYTES), _HEAD_DTYPE)
    if len(head) != 1 or head["magic"][0] != HEAD_MAGIC \
            or head["version"][0] != 1:
        raise IOError(f"{path}: bad record head magic/version")
    return head


def probe_bin(path: str, use_native: bool = True) -> BinFrameMeta:
    """Read the first record head and derive the record count."""
    if use_native:
        n_prt, n_samples, n_channels, freq_no = native.binio_probe_native(
            path)
        head = _read_head(path)
        return BinFrameMeta(n_prt, n_samples, n_channels, freq_no,
                            float(head["fs_hz"][0]), float(head["prt_s"][0]))
    head = _read_head(path)
    n_samples = int(head["n_samples"][0])
    n_channels = int(head["n_channels"][0])
    size = os.path.getsize(path)
    rec = _record_bytes(n_samples, n_channels)
    if size % rec != 0:
        raise IOError(f"{path}: size {size} is not a whole number of "
                      f"{rec}-byte records")
    return BinFrameMeta(size // rec, n_samples, n_channels,
                        int(head["freq_no"][0]), float(head["fs_hz"][0]),
                        float(head["prt_s"][0]))


def _read_numpy(path: str, meta: BinFrameMeta):
    """(iq float32 [n_prt, n_samples, n_channels, 2], servo, realtime) by
    numpy, checking every record's magics and checksum."""
    rec = _record_bytes(meta.n_samples, meta.n_channels)
    plane = meta.n_samples * meta.n_channels
    raw = np.fromfile(path, np.uint8).reshape(meta.n_prt, rec)
    heads = raw[:, :HEAD_BYTES].copy().view(_HEAD_DTYPE).reshape(meta.n_prt)
    if not (heads["magic"] == HEAD_MAGIC).all():
        raise IOError(f"{path}: bad record head magic")
    payload_u8 = raw[:, HEAD_BYTES:HEAD_BYTES + plane * 4]
    ends = raw[:, -END_BYTES:].copy().view(_END_DTYPE).reshape(meta.n_prt)
    if not (ends["magic"] == END_MAGIC).all():
        raise IOError(f"{path}: bad record end magic")
    sums = payload_u8.astype(np.uint64).sum(axis=1) & 0xFFFFFFFF
    if not (sums == ends["checksum"].astype(np.uint64)).all():
        raise IOError(f"{path}: payload checksum mismatch")
    quant = payload_u8.copy().view("<i2").reshape(
        meta.n_prt, meta.n_samples, meta.n_channels, 2)
    scales = heads["iq_scale"].astype(np.float32)[:, None, None, None]
    iq = (quant * scales).astype(np.float32)
    realtime = raw[:, HEAD_BYTES + plane * 4:-END_BYTES].copy().view(
        "<f8").reshape(meta.n_prt, REALTIME_BYTES // 8)
    return iq, heads["servo_angle_deg"].astype(np.float64), realtime


def read_bin(path: str, use_native: bool = True, device="cuda"):
    """Read a .bin record file. Returns ``(iq complex64 [n_prt, n_samples,
    n_channels], meta BinFrameMeta, servo float64 [n_prt], realtime float64
    [n_prt, 16])``, the arrays as tensors on ``device``."""
    device = torch.device(device)
    meta = probe_bin(path, use_native=use_native)
    shape = (meta.n_prt, meta.n_samples, meta.n_channels, 2)
    if use_native:
        pin = device.type == "cuda"
        iq = torch.empty(shape, dtype=torch.float32, pin_memory=pin)
        realtime = torch.empty((meta.n_prt, REALTIME_BYTES // 8),
                               dtype=torch.float64)
        servo = torch.empty(meta.n_prt, dtype=torch.float64)
        native.binio_read_native(path, iq, realtime, servo)
    else:
        iq, servo, realtime = (torch.from_numpy(a)
                               for a in _read_numpy(path, meta))
    iq = torch.view_as_complex(iq.to(device, non_blocking=True))
    return iq, meta, servo.to(device), realtime.to(device)


def read_bin_frames(path: str, prt_per_frame: int, use_native: bool = True,
                    device="cuda"):
    """Read and split into frames: ``(iq [n_frames, prt_per_frame, samples,
    channels], meta, servo [n_frames, prt_per_frame])`` on ``device``. The
    record count must be a whole number of frames."""
    iq, meta, servo, _ = read_bin(path, use_native=use_native,
                                  device=device)
    if meta.n_prt % prt_per_frame != 0:
        raise ValueError(f"{meta.n_prt} records is not a whole number of "
                         f"{prt_per_frame}-PRT frames")
    n_frames = meta.n_prt // prt_per_frame
    return (iq.reshape(n_frames, prt_per_frame, meta.n_samples,
                       meta.n_channels),
            meta, servo.reshape(n_frames, prt_per_frame))
