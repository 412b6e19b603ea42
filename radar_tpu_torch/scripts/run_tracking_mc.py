"""Tracking-layer Monte-Carlo on the port — port of
``scripts/run_tracking_mc.py``: the statistical validation the detection
layer got via ROC curves, applied to the INTER-FRAME ASSOCIATOR
(main_simulate_echoes_with_array_v8_3.m:253-335). N randomized
multi-target scenes, each run for F frames through the full pipeline
(the device-scan runner) and 5D association, scored with TRACK-level
metrics (track Pd, false-track rate, fragmentation, ID switches, purity;
``pipeline/track_metrics.py``).

Scene types (cycled):
  - random:   5 independent targets across the detection region;
  - close:    a closely-spaced pair (dR ~50 m, dV ~1.5 m/s — just above
              the stage-1 cluster gates of 30 m / 0.4 m/s) + 3 random;
  - crossing: a pair whose RANGE tracks cross mid-run (opposite radial
              velocities; the 5D gate's dV<=0.4 m/s must keep the two
              tracks apart where a range-only tracker would swap) + 3
              random.

Scene ``s`` draws from ``numpy.random.default_rng(seed + 1000 + s)``, as
the JAX script does, and runs with seed ``seed + 5000 + s``. The JSON has
the JAX script's keys; ``device`` holds the card's name and power limit.

Usage:
  python -m radar_tpu_torch.scripts.run_tracking_mc        # card, perf
  python -m radar_tpu_torch.scripts.run_tracking_mc --device cpu --small \\
      --scenes 3 --frames 8
Artifact: results/tracking_mc_torch.json (runs with --small or on the CPU:
build/tracking_mc_torch.json).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np

SCENE_TYPES = ("random", "close", "crossing")


def make_scene(rng, cfg, scene_type: str, num_frames: int, el_range=None):
    """5-target TargetBatch of the given type (see module docstring).

    ``el_range``: override for the elevation draw — scaled synthesized
    banks (e.g. the 64-ch -16..+3.2 deg fan) are narrower than
    random_scene's default -10..40 span; a truth outside the beam fan
    would score as a spurious miss."""
    from ..pipeline.streaming import random_scene
    from ..sim.scenario import TargetBatch

    base = random_scene(rng, 5, cfg, snr_range=(0.0, 15.0))
    r = base.range_m.copy()
    v = base.velocity_ms.copy()
    el = base.elevation_deg.copy()
    snr = base.snr_db.copy()
    if el_range is not None:
        el = rng.uniform(el_range[0], el_range[1], len(el))
    t_frame = cfg.sig.frame_time
    border_v = cfg.cfar.ref_cells_v + cfg.cfar.guard_cells_v
    v_lo = ((border_v + 2) / cfg.sig.prt_num - 0.5) * cfg.sig.v_max
    v_hi = ((cfg.sig.prt_num - border_v - 2) / cfg.sig.prt_num
            - 0.5) * cfg.sig.v_max
    if scene_type == "close":
        # pair 0/1: just above the stage-1 cluster gates (30 m, 0.4 m/s).
        # Step the velocity DOWN when +dv would leave the valid Doppler
        # region: an aliased injected target would score as a miss
        r[1] = r[0] + rng.uniform(45.0, 70.0)
        dv = rng.uniform(1.0, 2.0)
        v[1] = v[0] + dv if v[0] + dv <= v_hi else v[0] - dv
        el[1] = el[0] + rng.uniform(-1.0, 1.0)
    elif scene_type == "crossing":
        # pair 0/1: range tracks cross at ~0.6 * num_frames; both
        # velocities stay inside the valid Doppler band
        span = v.max() - v.min()
        dv = min(30.0, span) if span > 10 else 30.0
        dv = min(dv, 0.9 * (v_hi - v_lo))
        v0 = abs(v[0]) if abs(v[0]) > 5 else 15.0
        v[0] = min(max(v0, v_lo + dv), v_hi)
        v[1] = v[0] - dv                       # opposite/receding
        f_cross = 0.6 * num_frames
        r[1] = r[0] - dv * t_frame * f_cross   # R2 rises through R1
        el[1] = el[0] + rng.uniform(-1.0, 1.0)
    return TargetBatch.make(r, v, el, snr)


def device_record(device: str) -> str:
    """The card's name and power limit (nvidia-smi), or "cpu"."""
    import torch

    if device == "cpu":
        return "cpu"
    index = torch.device(device).index or 0
    try:
        limit = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        limit = "power limit not read"
    return f"{torch.cuda.get_device_name(index)}, {limit}"


def aggregate(items):
    """Track-level statistics over scene scores (the JSON's keys)."""
    if not items:
        return None
    return {
        "scenes": len(items),
        "track_pd": round(float(np.mean([x.track_pd for x in items])), 3),
        "false_tracks_per_scene": round(
            float(np.mean([x.false_tracks for x in items])), 3),
        # the false tracks that are elevation-sidelobe GHOSTS of a real
        # target (match a truth in R/V, fail the El gate); the rest is
        # clutter-born
        "ghost_tracks_per_scene": round(
            float(np.mean([x.ghost_tracks for x in items])), 3),
        "fragmentation": round(float(np.nanmean(
            [x.fragmentation for x in items])), 3),
        "switched_tracks_total": int(sum(x.switched_tracks for x in items)),
        "mean_purity": round(float(np.mean(
            [x.track_purity.mean() for x in items
             if len(x.track_purity)])), 3),
        "mean_coverage_detected": round(float(np.mean(
            np.concatenate([x.truth_coverage[x.truth_detected]
                            for x in items]))), 3),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=24)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions on the rank-K xla route")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--channels", type=int, default=None,
                    help="use scaled_config(channels, pulses) — the "
                         "BASELINE headline geometry is --channels 64 "
                         "--pulses 256 (synthesized Hamming bank; "
                         "elevations drawn inside its -16..+3.2 deg fan)")
    ap.add_argument("--pulses", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--exact", action="store_true",
                    help="exact-reference-stream path instead of perf")
    ap.add_argument("--stage2-vel-gate", type=float, default=None,
                    help="override the stage-2 anti-ghost velocity gate "
                         "(reference: max_vel_sep=0.4 m/s)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import dataclasses

    from ..config.params import (full_config, perf_config, scaled_config,
                                 small_test_config)
    from ..pipeline.driver import (associate_tracks, device_results_to_log,
                                   make_device_multiframe)
    from ..pipeline.track_metrics import DEFAULT_MATCH_GATES, score_tracks
    from ..waveform.precompute import precompute

    if args.small:
        cfg = small_test_config()
    elif args.channels is not None:
        cfg = scaled_config(channels=args.channels, pulses=args.pulses)
    else:
        cfg = full_config()
    on_cpu = args.device == "cpu"
    if not args.exact:
        cfg = perf_config(cfg, pallas=not on_cpu)
    if args.stage2_vel_gate is not None:
        cfg = cfg.replace(cluster=dataclasses.replace(
            cfg.cluster, stage2_vel_gate=args.stage2_vel_gate))
    pre = precompute(cfg)
    # keep truths inside the beam fan (binds only for narrow scaled banks)
    ang = np.asarray(pre.beam_angles_deg, float)
    el_lo, el_hi = max(-10.0, ang.min() + 1.0), min(40.0, ang.max() - 1.0)
    el_range = None if (el_lo, el_hi) == (-10.0, 40.0) else (el_lo, el_hi)
    runner = make_device_multiframe(cfg, pre, kinematics="simple",
                                    device=args.device)

    per_scene = []
    t0 = time.perf_counter()
    for s in range(args.scenes):
        stype = SCENE_TYPES[s % len(SCENE_TYPES)]
        rng = np.random.default_rng(args.seed + 1000 + s)
        truth = make_scene(rng, cfg, stype, args.frames, el_range)
        results, azimuths, _ = runner(args.seed + 5000 + s, truth,
                                      args.frames)
        log = device_results_to_log(results, azimuths)
        tracks = associate_tracks(log, cfg)
        sc = score_tracks(log, tracks, truth, args.frames, cfg,
                          kinematics="simple")
        per_scene.append((stype, sc))
        print(f"scene {s + 1}/{args.scenes} [{stype}]: "
              f"{len(log)} det -> {len(tracks)} tracks, "
              f"Pd={sc.track_pd:.2f} false={sc.false_tracks} "
              f"(ghost={sc.ghost_tracks}) "
              f"frag={sc.fragmentation:.2f} switch={sc.switched_tracks}",
              flush=True)
    wall = time.perf_counter() - t0

    overall = aggregate([sc for _, sc in per_scene])
    by_type = {t: aggregate([sc for st, sc in per_scene if st == t])
               for t in SCENE_TYPES}
    print(f"\noverall ({args.scenes} scenes x {args.frames} frames, "
          f"{wall:.0f}s): {json.dumps(overall)}")

    name = ("tracking_mc_torch.json" if args.channels is None
            else f"tracking_mc_{args.channels}ch_torch.json")
    out = args.out or os.path.join(
        "build" if (args.small or on_cpu) else "results", name)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump({
            "what": ("tracking-layer Monte-Carlo: randomized 5-target "
                     "scenes (random/close/crossing pair types) through "
                     "the full pipeline + 5D association "
                     "(v8_3.m:253-335), track-level metrics"),
            "device": device_record(args.device),
            "config": {"channels": cfg.sig.channel_num,
                       "pulses": cfg.sig.prt_num, "seed": args.seed,
                       "path": "exact" if args.exact else "perf",
                       "stage2_vel_gate": args.stage2_vel_gate},
            "scenes": args.scenes,
            "frames_per_scene": args.frames,
            "wall_s": round(wall, 1),
            "overall": overall,
            "by_scene_type": by_type,
            "match_gates": dict(DEFAULT_MATCH_GATES),
        }, f, indent=1)
    print("wrote", out)


if __name__ == "__main__":
    main()
