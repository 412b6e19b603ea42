"""The reference's HARDEST end-to-end demonstration — port of
``scripts/run_headline_5target.py``: the v8_2 five-target scene (SNR
-20..+15 dB, main_simulate_echoes_with_array_v8_2.m:28-51) for 50 frames
with the v8_2 simple kinematics (R -= V*T, El/V constant, v8_2:200-205),
through the full pipeline + 5D track association (v8_2:227-332), scored
with track-level metrics against the 5 injected trajectories — including
the fate of the -20 dB target among four stronger ones.

    python -m radar_tpu_torch.scripts.run_headline_5target  # card, perf
    python -m radar_tpu_torch.scripts.run_headline_5target --cpu --small

Artifact: ``results/headline_5target_torch.json`` (``build/`` with
``--cpu`` or ``--small``), the JAX script's keys plus the card's name and
power limit and the kernels' launches; ``--figures`` also draws the PPI
and track history beside it (needs matplotlib).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ._common import (artifact_path, device_record, kernel_launches,
                      launches_since, pick_device, require_matplotlib,
                      write_json)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the host")
    ap.add_argument("--small", action="store_true",
                    help="8-channel/32-pulse smoke config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=1,
                    help="repeat the run across N seeds (seed, seed+1, "
                         "...) and aggregate per-target outcomes — the "
                         "robustness arm; figures/headline fields come "
                         "from the first seed")
    ap.add_argument("--exact", action="store_true",
                    help="exact-reference-stream path instead of the perf "
                         "config")
    ap.add_argument("--out", default=None,
                    help="JSON artifact path (default results/"
                         "headline_5target_torch.json; build/ with --cpu "
                         "or --small)")
    ap.add_argument("--figures", action="store_true",
                    help="draw the PPI and track history beside the JSON "
                         "(needs matplotlib)")
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = artifact_path("headline_5target_torch.json",
                                 args.small or args.cpu)
    return args


def run(args, device) -> dict:
    from ..config.params import full_config, perf_config, small_test_config
    from ..pipeline.driver import run_multiframe_device
    from ..pipeline.track_metrics import DEFAULT_MATCH_GATES, score_tracks
    from ..sim.scenario import five_target_scene
    from ..waveform.precompute import precompute

    cfg = small_test_config() if args.small else full_config()
    if not args.exact:
        cfg = perf_config(cfg, pallas=device.type == "cuda")
    pre = precompute(cfg)
    scene = five_target_scene()

    before = kernel_launches()
    t0 = time.perf_counter()
    runs = []
    for s in range(args.seed, args.seed + args.seeds):
        log, tracks = run_multiframe_device(cfg, scene, args.frames,
                                            seed=s, precomp=pre,
                                            kinematics="simple",
                                            device=device)
        sc = score_tracks(log, tracks, scene, args.frames, cfg,
                          kinematics="simple")
        runs.append((s, log, tracks, sc))
        if args.seeds > 1:
            print(f"seed {s}: {len(log)} det -> {len(tracks)} tracks, "
                  f"Pd={sc.track_pd:.2f} false={sc.false_tracks} "
                  f"frag={sc.fragmentation:.2f}", flush=True)
    wall = time.perf_counter() - t0
    launches = launches_since(before)
    _, log, tracks, score = runs[0]
    print(f"{args.seeds} x {args.frames} frames in {wall:.1f}s; seed "
          f"{args.seed}: {len(log)} detections -> {len(tracks)} tracks")
    per_target = []
    for k in range(scene.num_targets):
        per_target.append({
            "truth": {"range_m": float(scene.range_m[k]),
                      "velocity_ms": float(scene.velocity_ms[k]),
                      "elevation_deg": float(scene.elevation_deg[k]),
                      "snr_db": float(scene.snr_db[k])},
            "detected": bool(score.truth_detected[k]),
            "coverage": round(float(score.truth_coverage[k]), 3),
            "n_tracks": int(score.truth_n_tracks[k]),
        })
        t = per_target[-1]
        print(f"  target {k + 1} (SNR {scene.snr_db[k]:+.0f} dB, "
              f"R {scene.range_m[k]:.0f} m): "
              f"{'TRACKED' if t['detected'] else 'MISSED'} "
              f"coverage={t['coverage']:.2f} tracks={t['n_tracks']}")
    print(f"track Pd {score.track_pd:.2f}, false tracks "
          f"{score.false_tracks}, fragmentation {score.fragmentation:.2f}, "
          f"switches {score.switched_tracks}")

    artifact = {
        "what": ("v8_2 five-target headline scenario "
                 "(main_simulate_echoes_with_array_v8_2.m:28-51,200-205): "
                 f"{args.frames} frames, simple kinematics, "
                 f"{'exact-stream' if args.exact else 'perf'} config, "
                 "device-scan runner, 5D track association"),
        "device": device_record(device),
        "config": {"channels": cfg.sig.channel_num,
                   "pulses": cfg.sig.prt_num, "seed": args.seed},
        "frames": args.frames,
        "wall_s": round(wall, 2),
        "detections": len(log),
        "tracks": len(tracks),
        "track_pd": round(float(score.track_pd), 3),
        "false_tracks": int(score.false_tracks),
        # NaN when no truth was detected: JSON has no NaN, so None
        "fragmentation": (None if score.fragmentation != score.fragmentation
                          else round(float(score.fragmentation), 3)),
        "switched_tracks": int(score.switched_tracks),
        "per_target": per_target,
        "match_gates": dict(DEFAULT_MATCH_GATES),
        "launches": launches,
    }
    if args.seeds > 1:
        scs = [r[3] for r in runs]
        artifact["robustness"] = {
            "seeds": args.seeds,
            "track_pd_mean": round(float(np.mean(
                [s.track_pd for s in scs])), 4),
            "per_target_detected_rate": [
                round(float(np.mean([s.truth_detected[k] for s in scs])), 3)
                for k in range(scene.num_targets)],
            "per_target_coverage_mean": [
                round(float(np.mean([s.truth_coverage[k] for s in scs])), 3)
                for k in range(scene.num_targets)],
            "false_tracks_total": int(sum(s.false_tracks for s in scs)),
            # nanmean: a zero-detection seed contributes NaN
            "fragmentation_mean": round(float(np.nanmean(
                [s.fragmentation for s in scs])), 3),
        }
        print("robustness:", json.dumps(artifact["robustness"]))
    write_json(args.out, artifact)
    if args.figures:
        from ..viz.plots import plot_ppi, plot_track_history

        stem = args.out[:-5] if args.out.endswith(".json") else args.out
        print("figures:",
              plot_ppi(tracks, stem + "_ppi.png",
                       title=f"v8_2 five-target headline ({args.frames} "
                             "frames)"),
              plot_track_history(log, tracks, stem + "_history.png"))
    return artifact


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.figures:
        require_matplotlib("--figures")
    return run(args, pick_device(args.cpu))


if __name__ == "__main__":
    main()
