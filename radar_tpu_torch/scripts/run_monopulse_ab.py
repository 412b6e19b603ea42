"""A/B accuracy measurement of the refined-index monopulse variant
(cfg.monopulse_refined) against the reference's integer-index evaluation
— port of ``scripts/run_monopulse_ab.py``. The documented flaw is kept as
default ("known flaw", fun_process_single_frame.m:280-281): the monopulse
ratio reads the two member-beam RDM values at the INTEGER (v_idx, r_idx)
while the reported range/velocity are refined to subcell positions. The
variant (SURVEY.md section 7.1) evaluates each beam's spline surface at
the refined peak instead.

Runs the Monte-Carlo sweep harness (the reference's own acceptance
machinery, main_plot_snr_vs_angle_error.m) on the perf config at a few
SNRs with IDENTICAL seeds for both variants and reports the sigma(angle)
delta, and each variant's cost a frame (``e2e_cost``: host clock around
frames of the frame processor, after a warm-up, each ending in its copy
to the host).

    python -m radar_tpu_torch.scripts.run_monopulse_ab [--cpu --small]
        [--snrs=-38,-32,-26] [--trials 200]

Writes ``results/monopulse_refined_ab_torch.json`` (``build/`` with
``--cpu`` or ``--small``) with the card's name and power limit, the wall
time and the kernels' launches.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ._common import (artifact_path, device_record, kernel_launches,
                      launches_since, pick_device, write_json)

COST_FRAMES = 5


def frame_ms(cfg, pre, device, frames: int = COST_FRAMES) -> float:
    """Host-clock ms a frame of ``cfg``'s frame processor on the truth
    target, over ``frames`` frames after one warm-up, each ending in the
    copy of its final count to the host."""
    from ..pipeline.frame import make_frame_processor
    from ..sim.scenario import TargetBatch

    process = make_frame_processor(cfg, pre, device=device)
    truth = TargetBatch.make([10000.0], [20.0], [10.0], [10.0])
    int(process(0, truth).num_final)
    t0 = time.perf_counter()
    for i in range(frames):
        int(process(i + 1, truth).num_final)
    return (time.perf_counter() - t0) / frames * 1e3


def run(args, device) -> dict:
    from ..config.params import full_config, perf_config, small_test_config
    from ..pipeline.montecarlo import snr_sweep
    from ..waveform.precompute import precompute

    base = small_test_config(channels=8, pulses=32) if args.small \
        else full_config()
    cfg_int = perf_config(base, pallas=device.type == "cuda")
    cfg_ref = cfg_int.replace(monopulse_refined=True)
    pre = precompute(cfg_int)
    snrs = np.asarray([float(s) for s in args.snrs.split(",")])

    before = kernel_launches()
    t_start = time.perf_counter()
    rows = []
    for name, cfg in (("integer_flaw", cfg_int), ("refined", cfg_ref)):
        t0 = time.perf_counter()
        # precompute is independent of the monopulse flag: share one
        res = snr_sweep(cfg, snr_db_vector=snrs, num_trials=args.trials,
                        seed=7, batch_size=args.batch, precomp=pre,
                        device=device)
        print(f"{name}: {time.perf_counter() - t0:.0f}s")
        for s, sd, pd in zip(res.snr_db, res.angle_error_std,
                             res.detection_probability):
            print(f"  SNR {s:+6.1f}: sigma={sd:.4f} deg Pd={pd:.2f}")
            rows.append({"variant": name, "snr_db": float(s),
                         "sigma_deg": float(sd), "pd": float(pd)})
    sweep_s = time.perf_counter() - t_start
    launches = launches_since(before)

    # pairwise deltas at each SNR
    deltas = []
    for s in snrs:
        si = next(r for r in rows if r["variant"] == "integer_flaw"
                  and r["snr_db"] == s)
        sr = next(r for r in rows if r["variant"] == "refined"
                  and r["snr_db"] == s)
        deltas.append({
            "snr_db": float(s),
            "sigma_integer_deg": si["sigma_deg"],
            "sigma_refined_deg": sr["sigma_deg"],
            "ratio_refined_over_integer":
                round(sr["sigma_deg"] / si["sigma_deg"], 4)
                if si["sigma_deg"] else None,
        })
        print(f"SNR {s:+.0f}: sigma integer {si['sigma_deg']:.4f} vs "
              f"refined {sr['sigma_deg']:.4f} "
              f"({deltas[-1]['ratio_refined_over_integer']}x)")
    ms_int, ms_ref = frame_ms(cfg_int, pre, device), frame_ms(cfg_ref, pre,
                                                               device)
    print(f"frame: integer {ms_int:.3f} ms, refined {ms_ref:.3f} ms")
    return {
        "what": ("A/B: monopulse ratio at integer indices (reference "
                 "flaw, fun_process_single_frame.m:280-281, shipped "
                 "default) vs at the spline-refined subcell peak "
                 "(cfg.monopulse_refined) — identical seeds, sweep "
                 "harness of main_plot_snr_vs_angle_error.m"),
        "device": device_record(device),
        "config": f"{cfg_int.sig.channel_num}ch x {cfg_int.sig.prt_num}p",
        "trials_per_point": args.trials,
        "rows": rows,
        "deltas": deltas,
        "e2e_cost": {
            "ms_per_frame_integer": round(ms_int, 3),
            "ms_per_frame_refined": round(ms_ref, 3),
            "relative": round(ms_int / ms_ref, 3),
            "note": f"host clock around {COST_FRAMES} frames of each "
                    "variant's frame processor after a warm-up, each "
                    "ending in its copy to the host (same process)"},
        "wall_s": round(sweep_s, 3),
        "launches": launches,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the host")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--snrs", default="-38,-32,-26",
                    help="comma-separated SNR dB points (full-scale "
                         "detectable band is about -40 dB and up)")
    ap.add_argument("--trials", type=int, default=200)
    ap.add_argument("--batch", type=int, default=50)
    ap.add_argument("--out", default=None,
                    help="JSON path (default results/monopulse_refined_"
                         "ab_torch.json; build/ with --cpu or --small)")
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = artifact_path("monopulse_refined_ab_torch.json",
                                 args.cpu or args.small)
    report = run(args, pick_device(args.cpu))
    write_json(args.out, report)
    return report


if __name__ == "__main__":
    main()
