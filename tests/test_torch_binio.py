"""PyTorch port: the .bin record reader and writer (``io/binio.py``,
``csrc/binio.cpp`` through ``native.py``) held against the JAX package's:
the port's writers (native and numpy) write JAX's bytes, each reader reads
every writer's files to the same values, the quantization round trip is
JAX's, and ``use_native=True`` raises when the library cannot be built
(no numpy fallback). The native cases need the host compiler ``c++``, as
``tests/test_torch_native.py`` does."""

from __future__ import annotations

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from radar_tpu import native as jnative
from radar_tpu.io import binio as jbin

from radar_tpu_torch import _build, native
from radar_tpu_torch.io import binio as tbin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_iq(rng, n_prt=6, n_samples=40, n_channels=4, scale=3.0):
    return (scale * (rng.standard_normal((n_prt, n_samples, n_channels))
                     + 1j * rng.standard_normal((n_prt, n_samples,
                                                 n_channels)))
            ).astype(np.complex64)


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("use_native", [True, False])
def test_writer_writes_jax_bytes(tmp_path, use_native):
    """At an explicit scale every writer writes JAX's bytes. At the
    default scale (peak / 30000) the two routes quantize differently, in
    JAX as here (the C++ multiplies by the f64 reciprocal, numpy divides in
    f32): each port route writes its JAX route's bytes."""
    rng = np.random.default_rng(1)
    iq = _random_iq(rng)
    servo = np.linspace(10.0, 12.5, 6)
    realtime = rng.standard_normal((6, 16))
    kw = dict(freq_no=3, fs_hz=25e6, prt_s=232.76e-6, realtime=realtime)
    jbin.write_bin(str(tmp_path / "jax.bin"), iq, servo, iq_scale=1e-3,
                   use_native=False, **kw)
    meta = tbin.write_bin(str(tmp_path / "port.bin"), torch.from_numpy(iq),
                          servo, iq_scale=1e-3, use_native=use_native, **kw)
    assert _bytes(tmp_path / "port.bin") == _bytes(tmp_path / "jax.bin")
    assert (meta.n_prt, meta.n_samples, meta.n_channels, meta.freq_no) == \
        (6, 40, 4, 3)

    scale = jbin.default_iq_scale(iq)
    assert tbin.default_iq_scale(torch.from_numpy(iq)) == scale
    tbin.write_bin(str(tmp_path / "port0.bin"), iq, servo,
                   use_native=use_native, **kw)
    jax_path = str(tmp_path / "jax0.bin")
    if use_native:
        wrote = jnative.binio_write_native(
            jax_path, iq, realtime, servo, 3, 25e6, 232.76e-6, scale)
    else:
        jbin.write_bin(jax_path, iq, servo, use_native=False, **kw)
        wrote = True
    if wrote:   # JAX's own native library may be absent
        assert _bytes(tmp_path / "port0.bin") == _bytes(jax_path)


@pytest.mark.parametrize("reader_native", [True, False])
@pytest.mark.parametrize("writer", ["jax", "port_native", "port_numpy"])
def test_readers_read_every_writer(tmp_path, writer, reader_native):
    rng = np.random.default_rng(2)
    iq = _random_iq(rng, n_prt=8)
    servo = np.arange(8.0) * 0.5
    path = str(tmp_path / "frames.bin")
    if writer == "jax":
        jbin.write_bin(path, iq, servo, freq_no=7, iq_scale=1e-3,
                       use_native=False)
    else:
        tbin.write_bin(path, iq, servo, freq_no=7, iq_scale=1e-3,
                       use_native=writer == "port_native")
    got, meta, servo_t, rt = tbin.read_bin(path, use_native=reader_native,
                                           device="cpu")
    want, jmeta, jservo, jrt = jbin.read_bin(path, use_native=False)
    assert meta == tbin.BinFrameMeta(*(getattr(jmeta, f) for f in
                                       ("n_prt", "n_samples", "n_channels",
                                        "freq_no", "fs_hz", "prt_s")))
    assert got.dtype == torch.complex64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(servo_t.numpy(), jservo)
    np.testing.assert_array_equal(rt.numpy(), jrt)
    assert np.abs(got.numpy() - iq).max() < 1e-4 * np.abs(iq).max() + 1e-3
    frames, fmeta, fservo = tbin.read_bin_frames(
        path, 4, use_native=reader_native, device="cpu")
    assert frames.shape == (2, 4, 40, 4) and fservo.shape == (2, 4)
    assert float(fservo[1, 0]) == 2.0
    with pytest.raises(ValueError, match="whole number"):
        tbin.read_bin_frames(path, 3, use_native=reader_native, device="cpu")


@pytest.mark.parametrize("use_native", [True, False])
def test_corruption_and_bad_magic_detected(tmp_path, use_native):
    rng = np.random.default_rng(3)
    path = str(tmp_path / "frames.bin")
    tbin.write_bin(path, _random_iq(rng, n_prt=2), 0.0, use_native=False)
    data = bytearray(_bytes(path))
    data[tbin.HEAD_BYTES + 10] ^= 0xFF  # flip a payload byte
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(IOError):
        tbin.read_bin(path, use_native=use_native, device="cpu")
    junk = str(tmp_path / "junk.bin")
    with open(junk, "wb") as f:
        f.write(b"\x00" * 256)
    with pytest.raises(IOError):
        tbin.probe_bin(junk, use_native=use_native)


def test_binio_source_is_jax_engine():
    """``csrc/binio.cpp`` is ``radar_tpu/native/binio.cpp`` below its
    header comment."""
    body = lambda p: open(p).read().split("#include <cstdint>", 1)[1]
    assert body(os.path.join(_build._CSRC, "binio.cpp")) == body(
        os.path.join(REPO, "radar_tpu", "native", "binio.cpp"))


def test_binio_argtypes_match_the_c_entries():
    with open(os.path.join(_build._CSRC, "binio.cpp")) as f:
        text = f.read()
    text = text[text.index('extern "C"'):]
    c_types = {"const char*": ctypes.c_char_p,
               "float*": ctypes.POINTER(ctypes.c_float),
               "const float*": ctypes.POINTER(ctypes.c_float),
               "double*": ctypes.POINTER(ctypes.c_double),
               "const double*": ctypes.POINTER(ctypes.c_double),
               "int64_t*": ctypes.POINTER(ctypes.c_int64),
               "int64_t": ctypes.c_int64, "double": ctypes.c_double}
    entries = {}
    for m in re.finditer(r"^int64_t (\w+)\(([^)]*)\)\s*\{", text, re.M):
        params = [" ".join(p.split()[:-1]) for p in m.group(2).split(",")]
        entries[m.group(1)] = [c_types[p] for p in params]
    assert entries == native._BINIO_SIGNATURES


def test_use_native_raises_when_the_library_cannot_build(tmp_path,
                                                         monkeypatch):
    """No fallback: a reader that does not compile raises with the
    compiler's message, for the writer, the probe and the reader; the
    numpy route (use_native=False) still works."""
    good = str(tmp_path / "good.bin")
    tbin.write_bin(good, _random_iq(np.random.default_rng(4)), 0.0,
                   use_native=False)
    (tmp_path / "binio.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(_build, "_CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    iq = _random_iq(np.random.default_rng(5))
    with pytest.raises(RuntimeError, match="(?s)c\\+\\+ failed.*error"):
        tbin.write_bin(str(tmp_path / "x.bin"), iq, 0.0)
    for call in (lambda: tbin.probe_bin(good),
                 lambda: tbin.read_bin(good, device="cpu")):
        with pytest.raises(RuntimeError, match="c\\+\\+ failed"):
            call()
    got, *_ = tbin.read_bin(good, use_native=False, device="cpu")
    assert got.shape == (6, 40, 4)


def test_read_bin_defaults_to_the_card(tmp_path):
    """The readers' default device is the card; without one the call
    raises instead of returning CPU tensors."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    path = str(tmp_path / "f.bin")
    tbin.write_bin(path, _random_iq(np.random.default_rng(6)), 0.0,
                   use_native=False)
    with pytest.raises((RuntimeError, AssertionError)):
        tbin.read_bin(path, use_native=False)
