"""Streaming many-target Monte-Carlo driver (BASELINE config 5) — port of
``scripts/run_streaming_mc.py``: scenes of random targets x noise trials,
detection-rate statistics vs SNR, range/velocity RMSE.

    python -m radar_tpu_torch.scripts.run_streaming_mc [--cpu] [--small]
        [--perf] [--scenes 32] [--targets 40] [--trials 8] [--json PATH]
        [--dp N] [--orbax DIR]

Runs on the card (``--cpu`` runs the plain versions on the host). Writes
the JAX script's ``--json`` keys, plus the card's name and power limit and
the kernels' launches, to ``--json`` (default
``results/streaming_mc_torch.json``; ``build/`` with ``--cpu`` or
``--small``). ``--dp N`` runs N ranks (``parallel.multihost.run_ranks``;
on one card they share it over gloo), each scene's trials sharded over
dp (``run_streaming_mc(mesh=, dp_trials=True)``); rank 0 writes the JSON.
``--orbax DIR`` checkpoints each scene's final targets
(``io/orbax_store.py``; with ``--dp`` each rank its own trials), and a
rerun replays the finished scenes, on another ``--dp`` too.
"""

from __future__ import annotations

import argparse
import time

from ._common import (artifact_path, device_record, kernel_launches,
                      launches_since, pick_device, ranks_launches, run_dp,
                      write_json)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the host")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--channels", type=int, default=0,
                    help="with --pulses: the scaled production config "
                         "(BASELINE config 3 geometry, e.g. 64 256)")
    ap.add_argument("--pulses", type=int, default=0)
    ap.add_argument("--perf", action="store_true",
                    help="perf pipeline configuration (rank-K signal, bf16 "
                         "matmuls, kernel K1's noise RDM on the card)")
    ap.add_argument("--scenes", type=int, default=32)
    ap.add_argument("--targets", type=int, default=40)
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--snr", default="-5:20", help="min:max injected SNR dB")
    ap.add_argument("--json", default=None,
                    help="statistics JSON (default results/"
                         "streaming_mc_torch.json; build/ with --cpu or "
                         "--small)")
    ap.add_argument("--dp", type=int, default=0,
                    help="shard each scene's trials over this many ranks "
                         "(the reference's parfor boundary on ranks)")
    ap.add_argument("--orbax", default=None, metavar="DIR",
                    help="checkpoint each scene's final targets here; a "
                         "rerun resumes completed scenes from disk, even "
                         "onto a different --dp")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.json is None:
        args.json = artifact_path("streaming_mc_torch.json",
                                  args.cpu or args.small)
    return args


def run(args, device, processor=None, mesh=None) -> dict:
    """The streaming study of ``args`` on ``device``; ``processor`` (a
    frame processor) replaces the one ``run_streaming_mc`` builds; with
    ``mesh`` (every rank of a ``--dp`` run) the trials shard over its dp
    axis and rank 0 reports."""
    from ..config.params import (full_config, perf_config, scaled_config,
                                 small_test_config)
    from ..pipeline.streaming import run_streaming_mc

    if args.channels and args.pulses:
        cfg = scaled_config(args.channels, args.pulses)
    else:
        cfg = small_test_config() if args.small else full_config()
    if args.perf:
        cfg = perf_config(cfg, pallas=device.type == "cuda")
    lo, hi = (float(x) for x in args.snr.split(":"))
    lead = mesh is None or mesh.rank == 0
    store = None
    if args.orbax:
        from ..io.orbax_store import OrbaxFrameStore

        store = OrbaxFrameStore(args.orbax)
        if store.frames_done() and lead:
            print(f"resuming: scenes {store.frames_done()} replay from "
                  f"{args.orbax}", flush=True)
    before = kernel_launches()
    t0 = time.perf_counter()
    stats = run_streaming_mc(cfg, num_scenes=args.scenes,
                             targets_per_scene=args.targets,
                             trials_per_scene=args.trials, seed=args.seed,
                             store=store, snr_range=(lo, hi), progress=True,
                             device=device, processor=processor, mesh=mesh,
                             dp_trials=mesh is not None)
    wall = time.perf_counter() - t0
    launches = ranks_launches(launches_since(before), mesh)
    if not lead:
        return {}
    total = args.scenes * args.targets * args.trials
    print(f"\n{total} injected targets in {wall:.1f}s "
          f"({total / wall:.0f} targets/s)")
    print(f"overall detection rate: {stats.detection_rate:.3f}")
    for lo_e, rate, n in zip(stats.snr_bin_edges[:-1], stats.snr_bin_rate,
                             stats.snr_bin_counts):
        print(f"  SNR >= {lo_e:+6.1f} dB: rate={rate:.2f} (n={n})")
    print(f"range RMSE {stats.range_rmse_m:.2f} m, "
          f"velocity RMSE {stats.velocity_rmse_ms:.3f} m/s")
    report = {
        "perf_config": args.perf,
        "injected_targets": total,
        "wall_s": round(wall, 1),
        "targets_per_s": round(total / wall, 1),
        "overall_rate": float(stats.detection_rate),
        "rate_by_snr": [float(x) for x in stats.snr_bin_rate],
        "snr_bin_edges": [float(x) for x in stats.snr_bin_edges],
        "range_rmse_m": float(stats.range_rmse_m),
        "velocity_rmse_ms": float(stats.velocity_rmse_ms),
        "device": device_record(device),
        "config": {"channels": cfg.sig.channel_num,
                   "pulses": cfg.sig.prt_num, "scenes": args.scenes,
                   "targets_per_scene": args.targets,
                   "trials_per_scene": args.trials, "seed": args.seed,
                   "dp": args.dp or 1},
        **launches,
    }
    write_json(args.json, report)
    return report


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.dp and args.trials % args.dp:
        raise SystemExit(f"--trials {args.trials} is not a multiple of "
                         f"--dp {args.dp}: each rank runs trials/dp a "
                         f"scene")
    device = pick_device(args.cpu)
    if args.dp:
        return run_dp(run, args, device)
    return run(args, device)


if __name__ == "__main__":
    main()
