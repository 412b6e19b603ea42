"""FULL-SCALE CFAR operating curve: Pd(T) AND Pfa(T) through the complete
16-channel pipeline in ONE artifact — port of ``scripts/run_roc_full.py``,
the single defensible number behind BASELINE's "CFAR Pd at fixed Pfa".

The reference fixes T_CFAR=8 (fun_process_single_frame.m:178) and measures
Pd only implicitly through the SNR sweep (main_plot_snr_vs_angle_error.m:
284,319-325); it never measures Pfa at all. This script runs both halves
at the full 16ch x 332-pulse frame geometry on the card:

- Pd(T): Monte-Carlo trials of a near-threshold truth target through the
  COMPLETE perf pipeline. The T-independent front (the rank-K signal RDM
  once, the noise RDM of kernel K1 per trial, the pair-sum maps and the
  GOCA noise map) runs once per trial, then the tail (mask -> extraction
  -> estimation -> clustering) runs per T. A trial counts as detected
  only if a FINAL target lands within (gate_r, gate_v) of the truth.
- Pfa(T): pure-noise frames through the SAME noise-RDM machinery (the
  noise RDM is the complete white-noise -> PC -> MTD -> mix chain; the
  signal adds linearly on top, so noise-only maps are exactly the
  no-target frame), per-cell exceedance counts for all T at once
  (``ops/cfar_analysis.count_exceedances_2d``). Zero-hit thresholds
  report the 95% upper bound 3/cells (rule of three).

    python -m radar_tpu_torch.scripts.run_roc_full [--cpu --small]
        [--trials 200] [--noise-frames 600] [--snr=-40]
        [--channels 64 --pulses 256 --truth-el=-0.8]

Writes ``results/roc_full_torch.json`` (``build/`` with ``--cpu`` or
``--small``) with the JAX keys, the card's name and power limit, the wall
time and the kernels' launches; ``--png`` draws the curves (needs
matplotlib). With ``--cpu`` the noise RDM is the plain rank-K chain.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ._common import (artifact_path, device_record, kernel_launches,
                      launches_since, pick_device, require_matplotlib,
                      write_json)

T_SWEEP = [3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0, 12.0]
T_REF = 8.0          # the reference operating point
SEED = 20260821


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the host (smoke runs)")
    ap.add_argument("--small", action="store_true",
                    help="small 8ch x 32p config (smoke only)")
    ap.add_argument("--snr", type=float, default=-40.0,
                    help="raw truth SNR dB for the Pd arm (default sits "
                         "in the full-scale T=8 transition)")
    ap.add_argument("--channels", type=int, default=None,
                    help="use scaled_config(channels, pulses) — the "
                         "BASELINE headline geometry is --channels 64 "
                         "--pulses 256 (synthesized Hamming bank; pair "
                         "with --truth-el=-0.8 --snr=-46)")
    ap.add_argument("--pulses", type=int, default=256)
    ap.add_argument("--truth-el", type=float, default=10.0,
                    help="truth elevation deg (must sit inside the "
                         "config's beam fan; the 64-ch bank spans "
                         "-16..+3.2 deg)")
    ap.add_argument("--trials", type=int, default=200)
    ap.add_argument("--batch", type=int, default=50,
                    help="trials between progress lines")
    ap.add_argument("--noise-frames", type=int, default=600)
    ap.add_argument("--noise-batch", type=int, default=100,
                    help="noise frames between progress lines")
    ap.add_argument("--gate-r", type=float, default=60.0)
    ap.add_argument("--gate-v", type=float, default=3.0)
    ap.add_argument("--out", default=None,
                    help="JSON path (default results/roc_full_torch.json; "
                         "build/ with --cpu or --small)")
    ap.add_argument("--png", default=None,
                    help="also draw the curves here (needs matplotlib)")
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = artifact_path("roc_full_torch.json",
                                 args.cpu or args.small)
    return args


def run(args, device) -> dict:
    from ..config.params import (full_config, perf_config, scaled_config,
                                 small_test_config)
    from ..ops.cfar import extract_detections, goca_noise_and_valid
    from ..ops.cfar_analysis import count_exceedances_2d
    from ..pipeline.driver import trial_seed
    from ..pipeline.frame import _estimate_and_cluster, measure_consts
    from ..pipeline.lowrank import make_lowrank_stages
    from ..sim.scenario import TargetBatch
    from ..utils.stats import wilson_ci
    from ..waveform.precompute import precompute

    if args.small:
        base = small_test_config(channels=8, pulses=32)
    elif args.channels is not None:
        base = scaled_config(channels=args.channels, pulses=args.pulses)
    else:
        base = full_config()
    cfg = perf_config(base, pallas=device.type == "cuda")
    pre = precompute(cfg)
    mc = measure_consts(cfg, pre, device=device)
    lr = make_lowrank_stages(cfg, pre, device=device)
    layout = lr.rdm_layout
    truth = TargetBatch.make([10000.0], [20.0], [args.truth_el],
                             [args.snr])
    r_true, v_true = float(truth.range_m[0]), float(truth.velocity_ms[0])
    cap = cfg.cfar.max_detections

    def vgb(rdm):
        """The route's RDM as a [V, G, B] view."""
        return rdm.permute(1, 2, 0) if layout == "bvg" else rdm

    def pair_maps(rdm):
        mag = vgb(rdm).abs()
        return mag[:, :, :-1] + mag[:, :, 1:]                 # [V, G, Q]

    def one_trial(echo, seed):
        """Hits [T] of one trial: the front once, the tail per T."""
        rdm = lr.noisy_rdm(echo, seed)
        maps = pair_maps(rdm)
        noise, valid = goca_noise_and_valid(maps, cfg.cfar)
        hits = []
        for t in T_SWEEP:
            mask = (maps > t * noise) & valid
            dets = extract_detections(mask, maps, cap, layout="vgq",
                                      native_scan=cfg.extract_native_scan)
            final = _estimate_and_cluster(cfg, mc, dets, maps, vgb(rdm),
                                          "vgb", "vgq")[-1].targets
            # detected = a FINAL target within the match gates of truth
            ok = (final.valid
                  & ((final.range_m - r_true).abs() <= args.gate_r)
                  & ((final.velocity_ms - v_true).abs() <= args.gate_v))
            hits.append(ok.any())
        return torch.stack(hits)

    before = kernel_launches()
    print(f"== Pd arm: SNR {args.snr:+.0f} dB, {args.trials} trials x "
          f"{len(T_SWEEP)} thresholds ==", flush=True)
    t0 = time.perf_counter()
    echo = lr.signal_rdm(truth, layout)               # rank-K, once
    pd_counts = torch.zeros(len(T_SWEEP), dtype=torch.int64, device=device)
    for i in range(args.trials):
        pd_counts += one_trial(echo, trial_seed(SEED, 0, i))
        if (i + 1) % args.batch == 0 or i + 1 == args.trials:
            print(f"  {i + 1}/{args.trials} trials "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    pd_counts = pd_counts.cpu().numpy()
    pd_s = time.perf_counter() - t0
    pds = pd_counts / args.trials
    for t, p in zip(T_SWEEP, pds):
        print(f"  T={t:5.1f}: Pd={p:.3f}", flush=True)

    print(f"== Pfa arm: {args.noise_frames} pure-noise full frames ==",
          flush=True)
    zero = torch.zeros_like(echo)
    t0 = time.perf_counter()
    counts = torch.zeros(len(T_SWEEP), dtype=torch.int64, device=device)
    cells = 0
    for f in range(args.noise_frames):
        c, n = count_exceedances_2d(
            pair_maps(lr.noisy_rdm(zero, trial_seed(SEED, 777, f))),
            cfg.cfar, T_SWEEP)
        counts += c
        cells += int(n)
        if (f + 1) % args.noise_batch == 0 or f + 1 == args.noise_frames:
            print(f"  {f + 1}/{args.noise_frames} frames, "
                  f"{cells / 1e6:.0f}M cells "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    counts = counts.cpu().numpy()
    pfa_s = time.perf_counter() - t0
    launches = launches_since(before)
    pfa = counts / cells
    # rule of three: 0 hits in N cells -> Pfa <= 3/N at 95% confidence
    pfa_bound = np.where(counts > 0, pfa, 3.0 / cells)
    for t, c, p, b in zip(T_SWEEP, counts, pfa, pfa_bound):
        tag = f"{p:.3e}" if c else f"<= {b:.1e} (0 hits, 95% bound)"
        print(f"  T={t:5.1f}: Pfa={tag}", flush=True)

    dev = device_record(device)
    pd_ci = [wilson_ci(int(c), args.trials) for c in pd_counts]
    i8 = T_SWEEP.index(T_REF)
    lo8, hi8 = pd_ci[i8]
    headline = {
        "t": T_REF, "snr_db": args.snr,
        "pd": float(pds[i8]),
        "trials": args.trials,
        "pd_ci95": [lo8, hi8],
        "pfa": float(pfa[i8]) if counts[i8] else None,
        "pfa_95_upper_bound": float(pfa_bound[i8]),
        "statement": (
            f"Pd={pds[i8]:.2f} (95% CI {lo8:.2f}-{hi8:.2f}, "
            f"{args.trials} trials) at Pfa"
            + (f"={pfa[i8]:.2e}" if counts[i8]
               else f"<={pfa_bound[i8]:.1e}")
            + f" (T={T_REF:g}, SNR {args.snr:+.0f} dB, "
              f"{cfg.sig.channel_num}ch x {cfg.sig.prt_num}p, {dev})"),
    }
    print("HEADLINE:", headline["statement"], flush=True)
    return {
        "device": dev,
        "config": (f"{cfg.sig.channel_num}ch x {cfg.sig.prt_num}p "
                   + ("small" if args.small
                      else "scaled" if args.channels is not None
                      else "FULL")
                   + (" perf(plain rank-K chain)" if device.type == "cpu"
                      else " perf(kernel K1)")),
        "truth_elevation_deg": args.truth_el,
        "pipeline": "complete: synthesis -> noise chain -> maps -> GOCA "
                    "CFAR -> extraction -> estimation -> clustering; "
                    "detection gated to truth "
                    f"(dR<={args.gate_r} m, dV<={args.gate_v} m/s)",
        "snr_db": args.snr, "trials_per_t": args.trials,
        "noise_frames": args.noise_frames, "noise_cells": int(cells),
        "t_factors": T_SWEEP,
        "pd": [float(p) for p in pds],
        "pd_hits": [int(c) for c in pd_counts],
        "pd_ci95": [[lo, hi] for lo, hi in pd_ci],
        "pfa": [float(p) for p in pfa],
        "pfa_hits": [int(c) for c in counts],
        "pfa_95_upper_bound": [float(b) for b in pfa_bound],
        "headline": headline,
        "method": "Pd: the front (signal RDM once, K1's noise RDM, maps, "
                  "GOCA noise map) once per trial, the tail per threshold; "
                  "Pfa via count_exceedances_2d on noise-only frames of "
                  "the same map machinery",
        "ref": "T_CFAR=8 operating point fun_process_single_frame.m:178; "
               "Pd machinery main_plot_snr_vs_angle_error.m:284,319-325",
        "wall_s": {"pd_arm": round(pd_s, 3), "pfa_arm": round(pfa_s, 3)},
        "launches": launches,
    }


def plot(report: dict, path: str) -> None:
    """The Pfa and Pd curves against T (needs matplotlib)."""
    from ..viz.plots import _pyplot, _save

    plt = _pyplot()
    ts, cells = report["t_factors"], report["noise_cells"]
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 9))
    ax1.semilogy(ts, np.maximum(report["pfa"], 0.5 / cells), "bo-",
                 label="measured Pfa")
    ax1.semilogy(ts, report["pfa_95_upper_bound"], "c--",
                 label="95% upper bound")
    ax1.axvline(T_REF, color="k", ls=":", label=f"reference T={T_REF:g}")
    ax1.set_xlabel("threshold factor T")
    ax1.set_ylabel("Pfa per cell")
    ax1.legend()
    ax1.grid(True)
    ax2.plot(ts, np.asarray(report["pd"]) * 100, "ms-")
    ax2.axvline(T_REF, color="k", ls=":")
    ax2.set_xlabel("threshold factor T")
    ax2.set_ylabel(f"Pd (%) at SNR {report['snr_db']:+.0f} dB "
                   "(truth-gated)")
    ax2.set_ylim(-5, 105)
    ax2.grid(True)
    fig.suptitle(report["headline"]["statement"], fontsize=9)
    fig.tight_layout()
    print("figure:", _save(fig, path), flush=True)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.png:
        require_matplotlib("--png")
    report = run(args, pick_device(args.cpu))
    write_json(args.out, report)
    if args.png:
        plot(report, args.png)
    return report


if __name__ == "__main__":
    main()
