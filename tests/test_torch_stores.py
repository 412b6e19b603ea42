"""PyTorch port: the checkpoint stores (``io/checkpoint.py``,
``io/orbax_store.py``) and resume through them, held as the JAX package's
tests hold its own (``tests/test_pipeline.py:209-300``,
``tests/test_streaming.py``): a run that stops and resumes from its store
gives the uninterrupted run's log, tracks and statistics bit for bit, and a
store written by a different run is refused."""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from radar_tpu.io import checkpoint as jcheckpoint

from radar_tpu_torch.config import params as tparams
from radar_tpu_torch.io import checkpoint as tcheckpoint
from radar_tpu_torch.io.checkpoint import CheckpointStore, SaveOptions
from radar_tpu_torch.io.orbax_store import OrbaxFrameStore
from radar_tpu_torch.pipeline import driver as tdriver
from radar_tpu_torch.pipeline.frame import make_frame_processor
from radar_tpu_torch.pipeline.streaming import run_streaming_mc
from radar_tpu_torch.sim.scenario import TargetBatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG_FIELDS = ("range_m", "velocity_ms", "elevation_deg", "power", "frame",
              "azimuth_deg")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers on the host's cores; these
    small-shape tests run torch on one thread, so the workers do not
    oversubscribe the cores (no hold here depends on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_log(got, want):
    assert len(got) == len(want) >= 1
    for f in LOG_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def _same_tracks(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a[:8] == b[:8]
        np.testing.assert_array_equal(a.member_idx, b.member_idx)


def test_multiframe_resume_after_crash(tmp_path):
    """A run that dies after frame 3 resumes from its per-frame
    measurement rows and gives the uninterrupted run's log and tracks."""
    cfg = tparams.small_test_config(channels=8, pulses=32)
    tb = TargetBatch.make([3000.0], [15.0], [10.0], [18.0])
    proc = make_frame_processor(cfg, device="cpu")
    log_full, tracks_full, _ = tdriver.run_multiframe(
        cfg, tb, 6, seed=4, processor=proc, device="cpu")

    store = CheckpointStore(str(tmp_path / "ck"),
                            SaveOptions(measurements=True))
    tdriver.run_multiframe(cfg, tb, 3, seed=4, processor=proc, store=store,
                           device="cpu")
    assert store.frames_done("measurements") == [1, 2, 3]
    log_res, tracks_res, _ = tdriver.run_multiframe(
        cfg, tb, 6, seed=4, processor=proc, store=store, device="cpu")
    assert store.frames_done("measurements") == [1, 2, 3, 4, 5, 6]
    _same_log(log_res, log_full)
    _same_tracks(tracks_res, tracks_full)

    with pytest.raises(ValueError, match="different run"):
        tdriver.run_multiframe(cfg, tb, 6, seed=5, processor=proc,
                               store=store, device="cpu")
    tb2 = TargetBatch.make([4000.0], [15.0], [10.0], [18.0])
    with pytest.raises(ValueError, match="different run"):
        tdriver.run_multiframe(cfg, tb2, 6, seed=4, processor=proc,
                               store=store, device="cpu")


def test_device_scan_chunked_resume(tmp_path):
    """The chunked device scan (carry threaded across chunks, absolute
    frame seeds) equals the unchunked run bit for bit; a 'crashed' run's
    chunks replay from the store and the resumed run reproduces the
    uninterrupted log exactly."""
    cfg = tparams.small_test_config(channels=8, pulses=32)
    tb = TargetBatch.make([3000.0], [15.0], [10.0], [18.0])
    log_full, tracks_full = tdriver.run_multiframe_device(
        cfg, tb, 6, seed=4, device="cpu")

    store = OrbaxFrameStore(str(tmp_path / "ck"))
    tdriver.run_multiframe_device(cfg, tb, 4, seed=4, store=store,
                                  chunk_frames=2, device="cpu")
    assert store.frames_done() == [2, 4]
    saved = store.restore(4)
    assert saved["l4"].dtype == np.bool_ and saved["l4"].shape[0] == 2
    assert saved["carry_az"].shape == () and saved["carry_az"].dtype == \
        np.float32
    log_res, tracks_res = tdriver.run_multiframe_device(
        cfg, tb, 6, seed=4, store=OrbaxFrameStore(str(tmp_path / "ck")),
        chunk_frames=2, device="cpu")
    assert store.frames_done() == [2, 4, 6]
    _same_log(log_res, log_full)
    _same_tracks(tracks_res, tracks_full)

    with pytest.raises(ValueError, match="different run"):
        tdriver.run_multiframe_device(
            cfg, tb, 6, seed=5, store=OrbaxFrameStore(str(tmp_path / "ck")),
            chunk_frames=2, device="cpu")
    with pytest.raises(ValueError, match="different run"):
        tdriver.run_multiframe_device(
            cfg, tb, 6, seed=4, store=OrbaxFrameStore(str(tmp_path / "ck")),
            chunk_frames=3, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        tdriver.run_multiframe_device(
            cfg, tb, 5, seed=4, store=OrbaxFrameStore(str(tmp_path / "c2")),
            chunk_frames=2, device="cpu")
    with pytest.raises(ValueError, match="chunk_frames > 0"):
        tdriver.run_multiframe_device(
            cfg, tb, 4, seed=4, store=OrbaxFrameStore(str(tmp_path / "c3")),
            device="cpu")


def test_frame_store_round_trip_and_torn_writes(tmp_path):
    store = OrbaxFrameStore(str(tmp_path / "st"))
    tree = {"flags": np.array([[True, False, True]]),
            "counts": np.arange(4, dtype=np.int64),
            "n": np.int32(7), "az": np.float32(12.5),
            "x": np.random.default_rng(0).normal(size=(3, 2)),
            "none": np.zeros((0, 5), np.float32),
            "t": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    store.save(3, tree)
    got = store.restore(3)
    assert set(got) == set(tree)
    for k, v in tree.items():
        want = v.numpy() if torch.is_tensor(v) else np.asarray(v)
        assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    assert store.has(3) and store.frames_done() == [3]
    store.save(3, {"a": np.ones(2)})
    assert set(store.restore(3)) == {"a"}
    # a save killed before its .metadata: not done, not present
    torn = tmp_path / "st" / "frame_000007"
    torn.mkdir()
    (torn / "__0_0.distcp").write_bytes(b"partial")
    (tmp_path / "st" / "frame_junk").mkdir()
    assert store.frames_done() == [3] and not store.has(7)
    assert OrbaxFrameStore(str(tmp_path / "st")).frames_done() == [3]


def test_checkpoint_store_matches_jax(tmp_path, monkeypatch):
    """The npz store: the JAX package's layout, atomic writes, the sim-frame
    and log files, and a manifest either package wrote guards both."""
    assert tcheckpoint.STAGE_DIRS == jcheckpoint.STAGE_DIRS
    assert dataclasses.asdict(SaveOptions()) == \
        dataclasses.asdict(jcheckpoint.SaveOptions())
    store = CheckpointStore(str(tmp_path / "ck"))
    assert store.save("pc", 1, x=np.ones(2)) is None      # switched off
    store.save("measurements", 1, range_m=np.arange(3.0))
    jstore = jcheckpoint.CheckpointStore(str(tmp_path / "ck"))
    assert jstore.frames_done("measurements") == [1]
    np.testing.assert_array_equal(jstore.load("measurements", 1)["range_m"],
                                  np.arange(3.0))
    real_savez = np.savez_compressed

    def dying_savez(path, **kw):
        real_savez(path, **kw)
        raise KeyboardInterrupt

    monkeypatch.setattr(np, "savez_compressed", dying_savez)
    with pytest.raises(KeyboardInterrupt):
        store.save("measurements", 2, range_m=np.arange(3.0))
    monkeypatch.undo()
    assert store.frames_done("measurements") == [1]
    assert not store.has("measurements", 2)

    manifest = {"seed": 1, "config_sha": "abc", "num_frames": None}
    jcheckpoint.check_run_manifest(str(tmp_path / "m"), manifest)
    tcheckpoint.check_run_manifest(str(tmp_path / "m"), manifest)
    with pytest.raises(ValueError, match="different run"):
        tcheckpoint.check_run_manifest(str(tmp_path / "m"),
                                       {**manifest, "seed": 2})
    with open(tmp_path / "m" / "run_manifest.json") as f:
        assert json.load(f) == {"seed": 1, "config_sha": "abc"}

    raw = np.arange(6, dtype=np.complex64).reshape(2, 3)
    tcheckpoint.save_sim_frame(str(tmp_path / "f" / "frame_1.npz"), raw,
                               12.5, 1)
    got = jcheckpoint.load_sim_frame(str(tmp_path / "f" / "frame_1.npz"))
    np.testing.assert_array_equal(got[0], raw)
    assert got[1:] == (12.5, 1) == tcheckpoint.load_sim_frame(
        str(tmp_path / "f" / "frame_1.npz"))[1:]
    log = tdriver.DetectionLog(np.array([1.0]), np.array([2.0]),
                               np.array([3.0]), np.array([4.0]),
                               np.array([5]), np.array([6.0]))
    tcheckpoint.save_detection_log_json(str(tmp_path / "a.json"), log)
    jcheckpoint.save_detection_log_json(str(tmp_path / "b.json"), log)
    assert (tmp_path / "a.json").read_text() == \
        (tmp_path / "b.json").read_text()


def test_run_fingerprint_matches_jax():
    from radar_tpu.config.params import small_test_config
    from radar_tpu.pipeline.driver import _run_fingerprint as jfp
    from radar_tpu.sim.scenario import TargetBatch as JTargets

    init = ([3000.0, 5000.0], [15.0, 3.0], [10.0, 2.0], [18.0, 5.0])
    want = jfp(small_test_config(), JTargets.make(*init), 4)
    got = tdriver._run_fingerprint(tparams.small_test_config(),
                                   TargetBatch.make(*init), 4)
    assert got == want


def test_streaming_resume_is_field_exact(tmp_path):
    cfg = tparams.small_test_config()
    kw = dict(targets_per_scene=3, trials_per_scene=2, seed=6,
              snr_range=(5.0, 20.0), device="cpu")
    proc = make_frame_processor(cfg, device="cpu")
    full = run_streaming_mc(cfg, num_scenes=3, processor=proc, **kw)
    store = OrbaxFrameStore(str(tmp_path / "st"))
    run_streaming_mc(cfg, num_scenes=2, processor=proc, store=store, **kw)
    assert store.frames_done() == [1, 2]
    resumed = run_streaming_mc(cfg, num_scenes=3, processor=proc,
                               store=OrbaxFrameStore(str(tmp_path / "st")),
                               **kw)
    assert store.frames_done() == [1, 2, 3]
    assert full.total_detected > 0
    for f in full._fields:
        np.testing.assert_array_equal(getattr(resumed, f), getattr(full, f),
                                      err_msg=f)
    with open(tmp_path / "st" / "run_manifest.json") as f:
        manifest = json.load(f)
    assert manifest["trial_route"] == "vmap"
    assert manifest["dtype"] == "complex64"
    for bad in ({"seed": 7}, {"trials_per_scene": 3},
                {"snr_range": (0.0, 20.0)}):
        with pytest.raises(ValueError, match="different run"):
            run_streaming_mc(cfg, num_scenes=3, processor=proc,
                             store=OrbaxFrameStore(str(tmp_path / "st")),
                             **{**kw, **bad})


def test_streaming_manifest_route_is_jax_rule(tmp_path):
    """The kernel routes of the rank-K stream record "map", JAX's
    trial_route for them (radar_tpu/pipeline/streaming.py:192-200)."""
    cfg = tparams.perf_config(tparams.small_test_config())
    run_streaming_mc(cfg, num_scenes=1, targets_per_scene=2,
                     trials_per_scene=1, device="cpu",
                     store=OrbaxFrameStore(str(tmp_path / "p")))
    with open(tmp_path / "p" / "run_manifest.json") as f:
        assert json.load(f)["trial_route"] == "map"


def test_tracking_modules_load_no_jax():
    code = ("import sys, radar_tpu_torch.pipeline.driver, "
            "radar_tpu_torch.pipeline.tracking, "
            "radar_tpu_torch.pipeline.track_metrics, "
            "radar_tpu_torch.io.orbax_store, radar_tpu_torch.native, "
            "radar_tpu_torch.scripts.run_tracking_mc; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'radar_tpu' or m.startswith('radar_tpu.') "
            "for m in sys.modules), 'radar_tpu imported'")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
