"""Multi-frame radar simulation driver — port of ``scripts/run_simulation.py``,
the framework's equivalent of the reference's primary entry point
``main_simulate_echoes_with_array_v8_3.m``: N frames of two-target
constant-altitude kinematics with servo scan, per frame the full
processing chain, then 5D track association.

    python -m radar_tpu_torch.scripts.run_simulation [--frames 50] [--cpu]
        [--small] [--out DIR] [--checkpoint] [--resume] [--device-scan]
        [--smooth] [--perf] [--five-target] [--kinematics altitude|simple]
        [--figures]

Runs on the card (``--cpu`` runs the plain versions on the host). Writes
``detection_log.json`` (and ``run.json``: the run's counts, wall time,
kernel launches and the card's name and power limit) under ``--out``,
by default ``out_sim_torch/`` (``build/out_sim_torch/`` with ``--cpu``).
``--figures`` draws the PPI, RHI, track-history and cluster-comparison
figures there (and the smoothed tracks with ``--smooth``); it needs
matplotlib, which the card's machine lacks, and exits naming it before
any frame runs.

``--resume`` persists each frame's measurements (host loop,
``io/checkpoint.py``) or each chunk of the device scan
(``--device-scan``, ``io/orbax_store.py``) under ``--out``; a rerun with
the same arguments replays what is done and continues, giving the
uninterrupted run's log.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from ._common import (REPO, device_record, kernel_launches, launches_since,
                      pick_device, require_matplotlib, write_json)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the host")
    ap.add_argument("--small", action="store_true",
                    help="8-channel/32-pulse small config")
    ap.add_argument("--out", default=None,
                    help="output directory (default out_sim_torch; "
                         "build/out_sim_torch with --cpu)")
    ap.add_argument("--checkpoint", action="store_true",
                    help="persist the cumulative measurement log")
    ap.add_argument("--resume", action="store_true",
                    help="restart-on-failure: persist per-frame "
                         "measurements as the loop runs and skip frames "
                         "already checkpointed under --out (an "
                         "interrupted run rerun with the same arguments "
                         "continues where it died; SURVEY 5.3)")
    ap.add_argument("--device-scan", action="store_true",
                    help="the device-scan runner: frames stay on the card "
                         "until a chunk ends (pipeline/driver.py::"
                         "run_multiframe_device)")
    ap.add_argument("--smooth", action="store_true",
                    help="Kalman/RTS-smooth the associated tracks")
    ap.add_argument("--perf", action="store_true",
                    help="run the perf configuration (rank-K signal RDM + "
                         "post-MTD beam-noise mixing, bf16 matmuls, kernel "
                         "K1's noise RDM)")
    ap.add_argument("--five-target", action="store_true",
                    help="run the v8_2 five-target scene (SNR -20..+15 dB, "
                         "main_simulate_echoes_with_array_v8_2.m:28-51) "
                         "instead of the v8_3 two-target scene; implies "
                         "--kinematics simple unless overridden")
    ap.add_argument("--kinematics", choices=("altitude", "simple"),
                    default=None,
                    help="track model: 'altitude' = v8_3 constant-altitude "
                         "(default), 'simple' = v8_2 R-=V*T with constant "
                         "El/V (v8_2.m:200-205)")
    ap.add_argument("--figures", action="store_true",
                    help="draw the figures under --out (needs matplotlib)")
    args = ap.parse_args(argv)
    if args.kinematics is None:
        args.kinematics = "simple" if args.five_target else "altitude"
    if args.out is None:
        args.out = os.path.join(REPO, "build" if args.cpu else "",
                                "out_sim_torch")
    return args


def _device_scan_store(args):
    """The chunked device scan's store under ``--out`` and its chunk size:
    the store's recorded one (``--frames`` must be a multiple of it), else
    the largest divisor of ``--frames`` up to 10."""
    from ..io.orbax_store import OrbaxFrameStore

    dstore = OrbaxFrameStore(os.path.join(args.out, "device_chunks"))
    manifest = os.path.join(dstore.root, "run_manifest.json")
    if os.path.exists(manifest):
        # the chunk size is part of the run identity: reuse it
        with open(manifest) as f:
            chunk = json.load(f)["chunk_frames"]
        if args.frames % chunk:
            raise SystemExit(f"--frames {args.frames} not divisible by the "
                             f"store's chunk_frames {chunk}")
    else:
        chunk = max(1, min(10, args.frames))
        while args.frames % chunk:
            chunk -= 1
    if dstore.frames_done():
        print(f"resuming: chunks ending at {dstore.frames_done()} replay "
              f"from {dstore.root}", flush=True)
    return dstore, chunk


def run(args, device, processor=None) -> dict:
    """The simulation of ``args`` on ``device``; ``processor`` (a frame
    processor called as ``processor(frame_seed, targets)``) replaces the
    host loop's own. Returns the report ``run.json`` holds."""
    from ..config.params import full_config, perf_config, small_test_config
    from ..io.checkpoint import (CheckpointStore, SaveOptions,
                                 save_detection_log_json)
    from ..pipeline.driver import run_multiframe, run_multiframe_device
    from ..sim.scenario import default_two_target_scene, five_target_scene
    from ..waveform.precompute import precompute

    cfg = small_test_config() if args.small else full_config()
    if args.perf:
        # kernel K1's noise RDM on the card; the plain rank-K chain on
        # the host
        cfg = perf_config(cfg, pallas=device.type == "cuda")
    pre = precompute(cfg)
    scene = (five_target_scene() if args.five_target
             else default_two_target_scene())

    before = kernel_launches()
    t0 = time.perf_counter()
    if args.device_scan:
        if processor is not None:
            raise ValueError("processor= drives the host loop; the device "
                             "scan builds its own")
        dstore, chunk = (_device_scan_store(args) if args.resume
                         else (None, None))
        log, tracks = run_multiframe_device(
            cfg, scene, args.frames, seed=0, precomp=pre, store=dstore,
            chunk_frames=chunk, kinematics=args.kinematics, device=device)
    else:
        store = None
        if args.resume:
            store = CheckpointStore(os.path.join(args.out, "checkpoints"),
                                    SaveOptions(measurements=True))
            done = store.frames_done("measurements")
            if done:
                print(f"resuming: frames {done[0]}..{done[-1]} replay "
                      f"from {store.root}", flush=True)
        log, tracks, _ = run_multiframe(
            cfg, scene, args.frames, seed=0, processor=processor,
            precomp=pre, progress=True, store=store,
            kinematics=args.kinematics, device=device)
    wall = time.perf_counter() - t0
    launches = launches_since(before)
    print(f"\nprocessed {args.frames} frames in {wall:.2f}s: "
          f"{len(log)} detections -> {len(tracks)} tracks", flush=True)
    for t in sorted(tracks, key=lambda t: -t.num_points)[:10]:
        print(f"  R={t.range_m:8.1f} m  V={t.velocity_ms:6.2f} m/s  "
              f"El={t.elevation_deg:5.2f} deg  Az={t.azimuth_deg:6.2f} deg  "
              f"frames {t.first_frame}-{t.last_frame} "
              f"({t.num_points} pts)")

    os.makedirs(args.out, exist_ok=True)
    smoothed = None
    if args.smooth:
        from ..pipeline.tracking import smooth_tracks

        smoothed = smooth_tracks(log, tracks, cfg)
        for st in smoothed:
            print(f"  smoothed: R={st.range_m[-1]:8.1f} m  "
                  f"V={st.velocity_ms[-1]:6.2f} m/s  "
                  f"El={st.elevation_deg[-1]:5.2f} deg  "
                  f"sigmaR={st.range_std_m[-1]:.1f} m  "
                  f"({len(st.frames)} frames)")
    if args.figures:
        from ..viz import plots

        out = lambda name: os.path.join(args.out, name)
        if smoothed is not None:
            print("smoothed figure:", plots.plot_smoothed_tracks(
                smoothed, out("smoothed_tracks.png")))
        print("figures:",
              plots.plot_ppi(tracks, out("ppi.png")),
              plots.plot_rhi(tracks, out("rhi.png")),
              plots.plot_track_history(log, tracks, out("track_history.png")),
              plots.plot_cluster_comparison(log, tracks, out("clusters.png")))
    save_detection_log_json(os.path.join(args.out, "detection_log.json"),
                            log)
    if args.checkpoint:
        store = CheckpointStore(os.path.join(args.out, "checkpoints"),
                                SaveOptions(cumulative_log=True))
        store.save("cumulative_log", args.frames,
                   range_m=log.range_m, velocity_ms=log.velocity_ms,
                   elevation_deg=log.elevation_deg, power=log.power,
                   frame=log.frame, azimuth_deg=log.azimuth_deg)
        print("checkpoints under", os.path.join(args.out, "checkpoints"))
    report = {
        "what": "multi-frame simulation (main_simulate_echoes_with_array_"
                "v8_3.m): frames through the processing chain, 5D track "
                "association",
        "device": device_record(device),
        "config": {"channels": cfg.sig.channel_num,
                   "pulses": cfg.sig.prt_num,
                   "path": "perf" if args.perf else "exact",
                   "runner": "device scan" if args.device_scan
                   else "host loop",
                   "scene": "five-target" if args.five_target
                   else "two-target", "kinematics": args.kinematics},
        "frames": args.frames, "wall_s": round(wall, 3),
        "frames_per_s": round(args.frames / wall, 3),
        "detections": len(log), "tracks": len(tracks),
        "launches": launches,
        "track_rows": [[t.range_m, t.velocity_ms, t.elevation_deg,
                        t.num_points] for t in tracks],
    }
    write_json(os.path.join(args.out, "run.json"), report)
    return report


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.figures:
        require_matplotlib("--figures")
    return run(args, pick_device(args.cpu))


if __name__ == "__main__":
    main()
