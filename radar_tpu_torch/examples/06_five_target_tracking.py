"""Tutorial: the v8_2 five-target scene and track-level scoring — port of
``examples/06_five_target_tracking.py``.

The reference's hardest end-to-end demonstration is the v8_2 driver's
five-target scene — SNR spread -20..+15 dB, so a -20 dB target must
survive CFAR next to four stronger ones
(main_simulate_echoes_with_array_v8_2.m:28-51). v8_2 evolves it with the
SIMPLE kinematic model (R -= V*T_frame, elevation/velocity constant,
v8_2.m:200-205).

This tutorial runs the scene at the small config through the device
multi-frame runner (no copy to the host between frames), associates
tracks with the 5D BFS (v8_2.m:227-332) and scores the result with the
track-level metrics of pipeline/track_metrics.py. The full-scale run is
``python -m radar_tpu_torch.scripts.run_headline_5target``.

Run: python -m radar_tpu_torch.examples.06_five_target_tracking [--cpu]
"""

from __future__ import annotations

import argparse

from ..config.params import small_test_config
from ..pipeline.driver import (associate_tracks, device_results_to_log,
                               make_device_multiframe)
from ..pipeline.track_metrics import score_tracks
from ..scripts._common import pick_device
from ..sim.scenario import five_target_scene


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the host")
    dev = pick_device(ap.parse_args(argv).cpu)
    cfg = small_test_config()
    scene = five_target_scene()
    n_frames = 8

    print("v8_2 five-target scene (v8_2.m:28-51):")
    for k in range(scene.num_targets):
        print(f"  target {k + 1}: R={scene.range_m[k]:7.0f} m  "
              f"V={scene.velocity_ms[k]:4.0f} m/s  "
              f"El={scene.elevation_deg[k]:4.0f} deg  "
              f"SNR={scene.snr_db[k]:+4.0f} dB")

    runner = make_device_multiframe(cfg, kinematics="simple", device=dev)
    results, azimuths, _ = runner(0, scene, n_frames)
    log = device_results_to_log(results, azimuths)
    tracks = associate_tracks(log, cfg)
    print(f"\n{n_frames} frames: {len(log)} detections -> "
          f"{len(tracks)} tracks")

    score = score_tracks(log, tracks, scene, n_frames, cfg,
                         kinematics="simple")
    for k in range(scene.num_targets):
        print(f"  target {k + 1} (SNR {scene.snr_db[k]:+.0f} dB): "
              f"{'TRACKED' if score.truth_detected[k] else 'MISSED'} "
              f"coverage={score.truth_coverage[k]:.2f} "
              f"tracks={score.truth_n_tracks[k]}")
    print(f"track Pd {score.track_pd:.2f}, false tracks "
          f"{score.false_tracks}, fragmentation {score.fragmentation:.2f}, "
          f"ID switches {score.switched_tracks}")
    if score.track_pd != 1.0:
        raise SystemExit("all five targets should be tracked")
    print("\nall five targets tracked — including the -20 dB one. The\n"
          "integration gain (PC ~28 dB + MTD ~25 dB) lifts it far above the\n"
          "CFAR threshold; what this scene really stresses is the "
          "CLUSTERING\ngates and 5D association keeping five tracks apart.")
    print(f"(small {cfg.sig.channel_num}ch x {cfg.sig.prt_num}p config)")
    return {"track_pd": score.track_pd, "false_tracks": score.false_tracks,
            "tracks": len(tracks), "detections": len(log)}


if __name__ == "__main__":
    main()
