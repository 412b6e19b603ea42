"""PyTorch port: the Kalman/RTS track smoother (``pipeline/tracking.py``)
and the track metrics (``pipeline/track_metrics.py``), host numpy in both
packages. On the same log and tracks the ``SmoothedTrack`` fields agree
with JAX's to rtol 1e-12 and the ``TrackScore`` is equal; then the
behaviour tests of ``tests/test_tracking.py`` and
``tests/test_track_metrics.py`` on the port (the live-pipeline ones on the
port's CPU frames)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from radar_tpu.config import params as jparams
from radar_tpu.pipeline import driver as jdriver
from radar_tpu.pipeline import track_metrics as jmetrics
from radar_tpu.pipeline import tracking as jtracking
from radar_tpu.sim.scenario import TargetBatch as JTargets

from radar_tpu_torch.config.params import small_test_config
from radar_tpu_torch.pipeline.driver import (DetectionLog, Track,
                                             associate_tracks,
                                             device_results_to_log,
                                             make_device_multiframe,
                                             run_multiframe)
from radar_tpu_torch.pipeline.track_metrics import (DEFAULT_MATCH_GATES,
                                                    TrackScore, score_tracks,
                                                    truth_trajectories)
from radar_tpu_torch.pipeline.tracking import (KalmanParams, SmoothedTrack,
                                               smooth_track, smooth_tracks)
from radar_tpu_torch.sim.scenario import (Scenario, TargetBatch,
                                          five_target_scene)

SCENE = ([3000.0, 9000.0, 6400.0], [20.0, 25.0, 22.0], [10.0, 30.0, 32.0],
         [10.0, 12.0, 8.0])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs several workers on the host's cores; these
    small-shape tests run torch on one thread, so the workers do not
    oversubscribe the cores (no hold here depends on the thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cv_log(cfg, n_frames=30, r0=9000.0, v=20.0, el0=10.0,
            sigma_r=6.0, sigma_v=0.5, sigma_el=0.5, seed=0,
            drop_frames=()):
    """Synthetic log of one closing constant-velocity target; returns
    (log, track, truth dict) (tests/test_tracking.py:14-36)."""
    t_frame = cfg.sig.frame_time
    rng = np.random.default_rng(seed)
    frames = np.array([f for f in range(1, n_frames + 1)
                       if f not in drop_frames])
    t = (frames - 1) * t_frame
    r_true = r0 - v * t
    el_true = np.full_like(r_true, el0)
    log = DetectionLog(
        range_m=r_true + sigma_r * rng.standard_normal(len(frames)),
        velocity_ms=v + sigma_v * rng.standard_normal(len(frames)),
        elevation_deg=el_true + sigma_el * rng.standard_normal(len(frames)),
        power=np.full(len(frames), 100.0),
        frame=frames,
        azimuth_deg=np.zeros(len(frames)))
    track = Track(r0, v, el0, 0.0, 100.0, int(frames[0]), int(frames[-1]),
                  len(frames), np.arange(len(frames)))
    return log, track, dict(r=r_true, v=v, el=el_true, frames=frames)


def _scene_log(rng, kinematics, n_frames=12):
    """Rows near SCENE's truth trajectories (two rows in some frames, some
    frames missed, a ghost and clutter), as both packages' logs."""
    cfg = small_test_config()
    traj = truth_trajectories(TargetBatch.make(*SCENE), n_frames, cfg,
                              kinematics)
    rows = []
    for k in range(3):
        for f in range(n_frames):
            for _ in range(rng.integers(0, 3)):
                rows.append((traj["range_m"][k, f] + rng.normal(0, 8),
                             traj["velocity_ms"][k, f] + rng.normal(0, 0.2),
                             traj["elevation_deg"][k, f] + rng.normal(0, 0.5),
                             rng.exponential(10), f + 1))
    for f in range(1, 5):                     # a ghost of target 2
        rows.append((traj["range_m"][2, f - 1], 22.2, 15.0, 1.0, f))
    for f in range(2, 5):                     # clutter
        rows.append((15000.0, -5.0, 5.0, 1.0, f))
    a = np.array(rows, float)
    cols = dict(range_m=a[:, 0], velocity_ms=a[:, 1], elevation_deg=a[:, 2],
                power=a[:, 3], frame=a[:, 4].astype(int),
                azimuth_deg=rng.uniform(0, 3, len(a)))
    return jdriver.DetectionLog(**cols), DetectionLog(**cols)


@pytest.mark.parametrize("kinematics", ["simple", "altitude"])
def test_smoother_and_scores_match_jax(kinematics):
    rng = np.random.default_rng(4)
    jlog, tlog = _scene_log(rng, kinematics)
    jcfg, tcfg = jparams.small_test_config(), small_test_config()
    jtracks = jdriver.associate_tracks(jlog, jcfg)
    tracks = associate_tracks(tlog, tcfg)
    assert len(tracks) == len(jtracks) >= 4
    params = KalmanParams(sigma_r=8.0, sigma_v=0.3, accel_psd=0.2)
    jparams_k = jtracking.KalmanParams(sigma_r=8.0, sigma_v=0.3,
                                       accel_psd=0.2)
    for p, jp in ((None, None), (params, jparams_k)):
        got = smooth_tracks(tlog, tracks, tcfg, p, min_points=2)
        want = jtracking.smooth_tracks(jlog, jtracks, jcfg, jp, min_points=2)
        assert len(got) == len(want) >= 3
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.frames, b.frames)
            for f in SmoothedTrack._fields[2:]:
                np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                           rtol=1e-12, atol=1e-300,
                                           err_msg=f)
            assert a.track.num_points == b.track.num_points
            np.testing.assert_allclose(a.predict(3, 0.2), b.predict(3, 0.2),
                                       rtol=1e-12)
    truth_t, truth_j = TargetBatch.make(*SCENE), JTargets.make(*SCENE)
    for kw in ({}, {"gate_r": 30.0, "purity_floor": 0.7,
                    "switch_floor": 0.2}):
        got = score_tracks(tlog, tracks, truth_t, 12, tcfg, kinematics, **kw)
        want = jmetrics.score_tracks(jlog, jtracks, truth_j, 12, jcfg,
                                     kinematics, **kw)
        for f in TrackScore.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
        assert (got.track_pd, got.fragmentation) == \
            (want.track_pd, want.fragmentation)
    assert want.ghost_tracks >= 1 and want.false_tracks >= 2
    for f in ("range_m", "velocity_ms", "elevation_deg"):
        np.testing.assert_array_equal(
            truth_trajectories(truth_t, 9, tcfg, kinematics)[f],
            jmetrics.truth_trajectories(truth_j, 9, jcfg, kinematics)[f])
    assert DEFAULT_MATCH_GATES == jmetrics.DEFAULT_MATCH_GATES
    assert KalmanParams() == KalmanParams(**vars(jtracking.KalmanParams()))


def test_smoother_beats_raw_measurements():
    cfg = small_test_config()
    log, track, truth = _cv_log(cfg, seed=1)
    st = smooth_track(log, track, cfg)
    rmse = lambda x, y: np.sqrt(np.mean((x - y) ** 2))
    assert rmse(st.range_m, truth["r"]) < \
        0.6 * rmse(st.meas_range_m, truth["r"])
    assert rmse(st.velocity_ms, truth["v"]) < \
        0.6 * rmse(st.meas_velocity_ms, truth["v"])
    assert rmse(st.elevation_deg, truth["el"]) < \
        0.6 * rmse(st.meas_elevation_deg, truth["el"])
    assert st.range_std_m[-1] < 6.0
    assert np.isfinite(st.innovation_nis).all()


def test_smoother_bridges_frame_gaps():
    cfg = small_test_config()
    log, track, truth = _cv_log(cfg, seed=2, drop_frames=(10, 11, 12, 20))
    st = smooth_track(log, track, cfg)
    np.testing.assert_array_equal(st.frames, truth["frames"])
    assert np.abs(st.range_m - truth["r"]).max() < 10.0
    r_pred, v_pred = st.predict(5, cfg.sig.frame_time)
    t_end = (truth["frames"][-1] - 1 + 5) * cfg.sig.frame_time
    assert abs(r_pred - (9000.0 - 20.0 * t_end)) < 15.0
    assert abs(v_pred - 20.0) < 0.5


def test_smoother_merges_same_frame_detections():
    cfg = small_test_config()
    log, track, _ = _cv_log(cfg, n_frames=5, seed=3)
    i = 2
    log2 = DetectionLog(
        np.concatenate([log.range_m, [log.range_m[i] + 6.0]]),
        np.concatenate([log.velocity_ms, [log.velocity_ms[i]]]),
        np.concatenate([log.elevation_deg, [log.elevation_deg[i]]]),
        np.concatenate([log.power, [200.0]]),
        np.concatenate([log.frame, [log.frame[i]]]),
        np.concatenate([log.azimuth_deg, [0.0]]))
    st = smooth_track(log2, track._replace(member_idx=np.arange(6),
                                           num_points=6), cfg)
    assert len(st.frames) == 5
    # the power-weighted mean: +6 * (200/300) = +4
    assert abs(st.meas_range_m[i] - (log.range_m[i] + 4.0)) < 1e-9


def test_smooth_tracks_min_points_filter():
    cfg = small_test_config()
    log, track, _ = _cv_log(cfg, n_frames=2, seed=4)
    assert smooth_tracks(log, [track], cfg, min_points=3) == []
    assert len(smooth_tracks(log, [track], cfg, min_points=2)) == 1


def test_smoothing_live_pipeline_track():
    """Multi-frame run of the port -> association -> smoothing; the
    smoothed trajectory follows the kinematic truth."""
    cfg = small_test_config(channels=8, pulses=32)
    tb = TargetBatch.make([3000.0], [10.0], [10.0], [20.0])
    n_frames = 6
    log, tracks, _ = run_multiframe(cfg, tb, n_frames, seed=0, device="cpu")
    smoothed = smooth_tracks(log, tracks, cfg,
                             KalmanParams(sigma_r=6.0, sigma_v=1.5,
                                          sigma_el=1.0))
    assert len(smoothed) >= 1
    st = max(smoothed, key=lambda s: len(s.frames))
    scen = Scenario.from_initial(tb, cfg)
    truth_r = np.array([scen.step(cfg).range_m[0]
                        for _ in range(n_frames)])[st.frames - 1]
    assert np.abs(st.range_m - truth_r).max() < 25.0
    assert np.abs(st.velocity_ms.mean() - 10.0) < 2.0


@pytest.mark.parametrize("kinematics", ["simple", "altitude"])
def test_truth_trajectories_match_scenario_step(kinematics):
    cfg = small_test_config()
    tb = (five_target_scene() if kinematics == "simple" else
          TargetBatch.make([3000.0, 9000.0], [20.0, 25.0], [10.0, 30.0],
                           [10.0, 10.0]))
    traj = truth_trajectories(tb, 5, cfg, kinematics=kinematics)
    scen = Scenario.from_initial(tb, cfg, kinematics=kinematics)
    for f in range(5):
        got = scen.step(cfg)
        for name in ("range_m", "velocity_ms", "elevation_deg"):
            np.testing.assert_allclose(traj[name][:, f], getattr(got, name))
    with pytest.raises(ValueError, match="kinematics"):
        truth_trajectories(tb, 5, cfg, kinematics="ballistic")


def _log_from_rows(rows):
    a = np.array(rows, float)
    return DetectionLog(a[:, 0], a[:, 1], a[:, 2], a[:, 3],
                        a[:, 4].astype(int), np.zeros(len(a)))


def _track(member_idx, first, last):
    return Track(0.0, 0.0, 0.0, 0.0, 1.0, first, last, len(member_idx),
                 np.asarray(member_idx))


def test_score_tracks_outcome_classes():
    """A clean track, a false track, a fragmented truth and a switched
    track each land in their metric (tests/test_track_metrics.py:82)."""
    cfg = small_test_config()
    t_frame = cfg.sig.frame_time
    truth = TargetBatch.make([3000.0, 8000.0], [20.0, 5.0], [10.0, 20.0],
                             [10.0, 10.0])
    rows = [(3000.0 - 20.0 * f * t_frame, 20.0, 10.0, 1.0, f)
            for f in range(1, 7)]
    rows += [(8000.0 - 5.0 * f * t_frame, 5.0, 20.0, 1.0, f)
             for f in (1, 2, 3, 5, 6)]
    rows += [(15000.0, -10.0, 5.0, 1.0, f) for f in (2, 3, 4)]
    log = _log_from_rows(rows)
    tracks = [_track(np.arange(0, 6), 1, 6), _track(np.arange(6, 9), 1, 3),
              _track(np.arange(9, 11), 5, 6), _track(np.arange(11, 14), 2, 4),
              _track(np.array([0, 1, 6, 7]), 1, 2)]
    sc = score_tracks(log, tracks, truth, 6, cfg, kinematics="simple")
    assert sc.truth_detected.all()
    assert sc.false_tracks == 1
    assert sc.truth_n_tracks[0] >= 1 and sc.truth_n_tracks[1] == 2
    assert sc.switched_tracks >= 1
    np.testing.assert_allclose(sc.truth_coverage, [1.0, 5.0 / 6.0])


def test_score_tracks_ghost_classification():
    cfg = small_test_config()
    t_frame = cfg.sig.frame_time
    truth = TargetBatch.make([6400.0], [22.0], [32.0], [10.0])
    rows = [(6400.0 - 22.0 * f * t_frame, 22.0, 32.0, 5.0, f)
            for f in range(1, 5)]
    rows += [(6400.0 - 22.0 * f * t_frame, 22.3, 15.0, 1.0, f)
             for f in range(1, 5)]
    rows += [(15000.0, -5.0, 5.0, 1.0, f) for f in range(1, 4)]
    tracks = [_track(np.arange(0, 4), 1, 4), _track(np.arange(4, 8), 1, 4),
              _track(np.arange(8, 11), 1, 3)]
    sc = score_tracks(_log_from_rows(rows), tracks, truth, 4, cfg,
                      kinematics="simple")
    assert sc.truth_detected.all()
    assert sc.false_tracks == 2 and sc.ghost_tracks == 1


def test_score_tracks_empty_log():
    cfg = small_test_config()
    truth = TargetBatch.make([3000.0], [20.0], [10.0], [10.0])
    sc = score_tracks(DetectionLog.empty(), [], truth, 5, cfg)
    assert sc.track_pd == 0.0 and sc.false_tracks == 0
    assert np.isnan(sc.fragmentation)


def test_simple_kinematics_device_scan_matches_host():
    """The runner's simple model reproduces ``Scenario.step`` (R -= V*T,
    El/V constant, v8_2:200-205) on the port's CPU frames."""
    cfg = small_test_config(channels=8, pulses=32)
    tb = TargetBatch.make([3000.0, 5000.0], [15.0, -10.0], [10.0, 5.0],
                          [20.0, 20.0])
    run = make_device_multiframe(cfg, kinematics="simple", device="cpu")
    _, azimuths, carry = run(0, tb, 4)
    scen = Scenario.from_initial(tb, cfg, kinematics="simple")
    for _ in range(4):
        last = scen.step(cfg)
    np.testing.assert_allclose(carry[1], last.range_m, rtol=1e-6)
    assert abs(float(azimuths[-1]) - scen.azimuth_deg) < 1e-4


def test_five_target_headline_small_e2e():
    """The v8_2 five-target scene end to end at small scale on the port's
    CPU frames: every truth, the -20 dB one included, gets a majority-pure
    track with high coverage (tests/test_track_metrics.py:196)."""
    cfg = small_test_config()
    tb = five_target_scene()
    n_frames = 8
    run = make_device_multiframe(cfg, kinematics="simple", device="cpu")
    results, azimuths, _ = run(0, tb, n_frames)
    log = device_results_to_log(results, azimuths)
    tracks = associate_tracks(log, cfg)
    sc = score_tracks(log, tracks, tb, n_frames, cfg, kinematics="simple")
    assert sc.track_pd == 1.0, sc
    assert (sc.truth_coverage >= 0.75).all(), sc.truth_coverage
    assert sc.false_tracks <= 1, sc.false_tracks
