"""PyTorch port: the native 5D track associator (``csrc/tracker.cpp``,
``native.py``) held against the JAX package's native engine and the dense
numpy BFS on the cases of ``tests/test_native.py:33-75`` (component ids
equal), ``associate_tracks`` against JAX's (equal tracks), and the build's
no-fallback rule: a source that does not compile raises with the
compiler's message."""

from __future__ import annotations

import ctypes
import dataclasses
import os
import re
import time

import numpy as np
import pytest

from radar_tpu.config import params as jparams
from radar_tpu.native import associate_tracks_5d_native as j_native
from radar_tpu.pipeline import driver as jdriver

from radar_tpu_torch import _build, native
from radar_tpu_torch.cluster.connected import connected_components_np
from radar_tpu_torch.config import params as tparams
from radar_tpu_torch.pipeline import driver as tdriver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATES = (30.0, 0.4, 10.0, 5.0, 3.0)
TRACK_FIELDS = ("range_m", "velocity_ms", "elevation_deg", "azimuth_deg",
                "power", "first_frame", "last_frame", "num_points")


def _dense(fields, gates):
    n = len(fields[0])
    adj = np.ones((n, n), bool)
    for f, g in zip(fields, gates):
        adj &= np.abs(f[:, None] - f[None, :]) <= g
    return connected_components_np(adj)


def _random_log(rng, n):
    return [rng.uniform(0, 20000, n),            # range
            rng.uniform(-40, 40, n),             # velocity
            rng.uniform(0, 360, n),              # azimuth
            rng.uniform(-10, 70, n),             # elevation
            rng.integers(1, 50, n).astype(float)]  # frame


def _clustered_log(rng):
    """Two planted tracks over 20 frames and 50 rows of noise."""
    centers = [(3000.0, 20.0, 45.0, 10.0), (9000.0, -15.0, 200.0, 30.0)]
    rows = [[], [], [], [], []]
    for frame in range(1, 21):
        for r0, v0, az0, el0 in centers:
            rows[0].append(r0 + rng.uniform(-10, 10))
            rows[1].append(v0 + rng.uniform(-0.1, 0.1))
            rows[2].append(az0 + rng.uniform(-2, 2))
            rows[3].append(el0 + rng.uniform(-1, 1))
            rows[4].append(float(frame))
    noise = _random_log(rng, 50)
    return [np.concatenate([np.asarray(a), b]) for a, b in zip(rows, noise)]


@pytest.mark.parametrize("seed", range(5))
def test_native_matches_jax_and_bfs_random(seed):
    fields = _random_log(np.random.default_rng(seed), 300)
    got = native.associate_tracks_5d_native(*fields, GATES)
    np.testing.assert_array_equal(got, _dense(fields, GATES))
    np.testing.assert_array_equal(got, j_native(*fields, GATES))


def test_native_matches_on_clustered_scene():
    fields = _clustered_log(np.random.default_rng(7))
    got = native.associate_tracks_5d_native(*fields, GATES)
    np.testing.assert_array_equal(got, _dense(fields, GATES))
    np.testing.assert_array_equal(got, j_native(*fields, GATES))
    assert got[0] != got[1]
    assert (got[:40:2] == got[0]).all() and (got[1:40:2] == got[1]).all()


def test_generic_gated_components():
    rng = np.random.default_rng(3)
    fields = [rng.uniform(0, 100, 200), rng.uniform(-5, 5, 200)]
    got = native.connected_components_gated_native(fields, (10.0, 1.0))
    np.testing.assert_array_equal(got, _dense(fields, (10.0, 1.0)))
    with pytest.raises(ValueError, match="gates"):
        native.connected_components_gated_native(fields, (10.0,))
    empty = native.associate_tracks_5d_native(*[np.zeros(0)] * 5, GATES)
    assert empty.shape == (0,)


def test_native_scales_to_10k():
    """BASELINE config 5 scale: 10k rows in well under a second (the dense
    BFS needs a 10^8-entry adjacency), the JAX engine's components."""
    fields = _random_log(np.random.default_rng(0), 10000)
    native.load_library()
    t0 = time.perf_counter()
    got = native.associate_tracks_5d_native(*fields, GATES)
    dt = time.perf_counter() - t0
    np.testing.assert_array_equal(got, j_native(*fields, GATES))
    assert dt < 1.0, dt


def _logs(fields, power):
    cols = dict(range_m=fields[0], velocity_ms=fields[1],
                azimuth_deg=fields[2], elevation_deg=fields[3],
                frame=fields[4].astype(int), power=power)
    return jdriver.DetectionLog(**cols), tdriver.DetectionLog(**cols)


@pytest.mark.parametrize("wrap", [False, True])
def test_associate_tracks_matches_jax_on_a_long_log(wrap):
    """A 2000-row log of 20 tracks over 100 frames and clutter: the
    native engine (and, with wrap_azimuth, the numpy BFS) gives JAX's
    tracks."""
    rng = np.random.default_rng(5)
    k, frames = 20, 100
    base = [rng.uniform(2000, 18000, k), rng.uniform(-30, 30, k),
            rng.uniform(0, 360, k), rng.uniform(-5, 40, k)]
    rows = [[], [], [], [], []]
    for f in range(1, frames + 1):
        hit = rng.uniform(size=k) < 0.9
        for c in range(4):
            rows[c].append(base[c][hit] + rng.normal(0, [5, 0.1, 1, 0.5][c],
                                                     hit.sum()))
        rows[4].append(np.full(hit.sum(), float(f)))
    fields = [np.concatenate(r) for r in rows]
    clutter = _random_log(rng, 200)
    fields = [np.concatenate([a, b]) for a, b in zip(fields, clutter)]
    jlog, tlog = _logs(fields, rng.exponential(5, len(fields[0])))
    cfgs = [m.small_test_config() for m in (jparams, tparams)]
    cfg_j, cfg_t = [c.replace(inter_frame=dataclasses.replace(
        c.inter_frame, wrap_azimuth=wrap)) for c in cfgs]
    if wrap:   # the dense BFS: a shorter log
        jlog, tlog = _logs([f[:600] for f in fields], jlog.power[:600])
    got = tdriver.associate_tracks(tlog, cfg_t)
    want = jdriver.associate_tracks(jlog, cfg_j)
    assert len(got) == len(want) >= 20
    for a, b in zip(got, want):
        for f in TRACK_FIELDS:
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       rtol=1e-12, err_msg=f)
        np.testing.assert_array_equal(a.member_idx, b.member_idx)


def test_tracker_source_is_jax_engine():
    """``csrc/tracker.cpp`` is ``radar_tpu/native/tracker.cpp`` below its
    header comment."""
    body = lambda p: open(p).read().split("#include <cstdint>", 1)[1]
    assert body(os.path.join(_build._CSRC, "tracker.cpp")) == body(
        os.path.join(REPO, "radar_tpu", "native", "tracker.cpp"))


def test_argtypes_match_the_c_entries():
    with open(os.path.join(_build._CSRC, "tracker.cpp")) as f:
        text = f.read()
    text = text[text.index('extern "C"'):]
    c_types = {"const double*": ctypes.POINTER(ctypes.c_double),
               "int64_t*": ctypes.POINTER(ctypes.c_int64),
               "int64_t": ctypes.c_int64}
    entries = {}
    for m in re.finditer(r"^int64_t (\w+)\(([^)]*)\)\s*\{", text, re.M):
        params = [" ".join(p.split()[:-1]) for p in m.group(2).split(",")]
        entries[m.group(1)] = [c_types[p] for p in params]
    assert entries == native._SIGNATURES


def test_failed_build_raises_with_the_compiler_message(tmp_path,
                                                       monkeypatch):
    """No fallback: a tracker that does not compile raises, and so does
    the association that needs it."""
    (tmp_path / "tracker.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(_build, "_CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="(?s)c\\+\\+ failed.*error"):
        native.load_library()
    _, tlog = _logs(_random_log(np.random.default_rng(1), 20), np.ones(20))
    with pytest.raises(RuntimeError, match="c\\+\\+ failed"):
        tdriver.associate_tracks(tlog, tparams.small_test_config())
    assert not os.listdir(tmp_path / "build")
