"""CFAR operating curve: Pd AND Pfa vs the threshold factor T — port of
``scripts/run_roc.py``, the two statistical halves of BASELINE's "CFAR Pd
at fixed Pfa" on one axis, at the small config (8 ch x 32 pulses; the
statistics are config-relative).

The reference fixes T_CFAR=8 (fun_process_single_frame.m:178) and never
measures either quantity; this script sweeps T through the full chain:

- Pd(T): Monte-Carlo trials of a truth target at a fixed raw SNR near the
  detection transition, through the COMPLETE pipeline (synthesis -> ... ->
  clustering, ``pipeline/montecarlo.py::make_trial_fn``) with
  cfar.threshold_factor=T — detection = any final target.
- Pfa(T): pure-noise frames through the stream pipeline, per-cell
  exceedance counts via ``ops/cfar_analysis.count_exceedances_2d`` (T as a
  broadcast vector) + the analytic GOCA expectation.

    python -m radar_tpu_torch.scripts.run_roc [--cpu] [--snr=-31]
        [--trials 48] [--noise-frames 24] [--out PATH] [--png PATH]

Runs on the card by default (the JAX script forces the CPU unless
``--tpu``; the port has ``--cpu`` instead). Writes
``results/roc_torch.json`` (``build/`` with ``--cpu``) with the JAX keys,
the card's name and power limit, the wall time and the kernels'
launches; ``--png`` draws the curves (needs matplotlib).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ._common import (artifact_path, device_record, kernel_launches,
                      launches_since, pick_device, require_matplotlib,
                      write_json)

T_SWEEP = [1.5, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0, 12.0]
SEED = 20260821


def run(args, device) -> dict:
    from ..config.params import small_test_config
    from ..ops.cfar_analysis import analytic_pfa_goca2d, count_exceedances_2d
    from ..pipeline.driver import trial_seed
    from ..pipeline.montecarlo import make_trial_fn
    from ..sim.scenario import TargetBatch
    from ..waveform.precompute import precompute
    from .run_pfa import make_noise_maps

    base = small_test_config(channels=8, pulses=32)
    pre = precompute(base)
    truth = TargetBatch.make([3000.0], [10.0], [10.0], [args.snr])
    before = kernel_launches()

    # ---- Pd(T): full chain per threshold --------------------------------
    print(f"== Pd at SNR {args.snr:+.0f} dB, {args.trials} trials/T ==",
          flush=True)
    pds = []
    t_pd = time.perf_counter()
    for t in T_SWEEP:
        cfg = base.replace(cfar=dataclasses.replace(
            base.cfar, threshold_factor=float(t)))
        trials_fn = make_trial_fn(cfg, pre, device=device)
        seeds = [trial_seed(SEED, int(10 * t), i) for i in range(args.trials)]
        t0 = time.perf_counter()
        _, hits = trials_fn(truth, seeds)
        pd = float(hits.double().mean())
        pds.append(pd)
        print(f"  T={t:5.1f}: Pd={pd:.3f}  ({time.perf_counter() - t0:.1f}s)",
              flush=True)
    pd_s = time.perf_counter() - t_pd

    # ---- Pfa(T): noise-only frames, all T at once -----------------------
    print(f"== Pfa over {args.noise_frames} pure-noise frames ==",
          flush=True)
    noise_maps = make_noise_maps(base, pre, device)
    t0 = time.perf_counter()
    counts = torch.zeros(len(T_SWEEP), dtype=torch.int64, device=device)
    cells = 0
    for f in range(args.noise_frames):
        c, n = count_exceedances_2d(noise_maps(trial_seed(SEED, 999, f)),
                                    base.cfar, T_SWEEP)
        counts += c
        cells += int(n)
    counts = counts.cpu().numpy()
    pfa_s = time.perf_counter() - t0
    pfas = counts / cells
    analytic = [analytic_pfa_goca2d(t, base.cfar) for t in T_SWEEP]
    for t, c, p, a in zip(T_SWEEP, counts, pfas, analytic):
        print(f"  T={t:5.1f}: Pfa={p:.3e} ({int(c)} hits, analytic "
              f"{a:.3e})", flush=True)

    return {
        "device": device_record(device),
        "config": "small (8ch x 32p)", "snr_db": args.snr,
        "trials_per_t": args.trials, "noise_cells": int(cells),
        "t_factors": T_SWEEP, "pd": pds,
        "pfa": [float(p) for p in pfas],
        "pfa_hits": [int(c) for c in counts],
        "pfa_analytic_exponential": analytic,
        "note": "operational amplitude-domain cells: the measured Pfa "
                "transition sits at lower T than the square-law analytic "
                "curve (same effect as the Pfa calibration's section 2); "
                "reference operating point T=8 "
                "(fun_process_single_frame.m:178)",
        "wall_s": {"pd_arm": round(pd_s, 3), "pfa_arm": round(pfa_s, 3)},
        "launches": launches_since(before),
    }


def plot(report: dict, path: str) -> None:
    """The Pfa and Pd curves against T (needs matplotlib)."""
    from ..viz.plots import _pyplot, _save

    plt = _pyplot()
    ts, cells = report["t_factors"], report["noise_cells"]
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 9))
    ax1.semilogy(ts, np.maximum(report["pfa"], 0.5 / cells), "bo-",
                 label="measured Pfa (floor = 0.5/cells)")
    ax1.semilogy(ts, report["pfa_analytic_exponential"], "r--",
                 label="analytic GOCA (square-law cells)")
    ax1.axvline(8.0, color="k", ls=":", label="reference T=8")
    ax1.set_xlabel("threshold factor T")
    ax1.set_ylabel("Pfa per cell")
    ax1.legend()
    ax1.grid(True)
    ax2.plot(ts, np.asarray(report["pd"]) * 100, "ms-")
    ax2.axvline(8.0, color="k", ls=":")
    ax2.set_xlabel("threshold factor T")
    ax2.set_ylabel(f"Pd (%) at SNR {report['snr_db']:+.0f} dB")
    ax2.set_ylim(-5, 105)
    ax2.grid(True)
    fig.tight_layout()
    print("figure:", _save(fig, path), flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the host")
    ap.add_argument("--snr", type=float, default=-31.0,
                    help="raw truth SNR in dB for the Pd arm (default "
                         "sits just above the small-config T=8 "
                         "transition at ~-28 dB so lowering T shows the "
                         "Pd/Pfa trade visibly)")
    ap.add_argument("--trials", type=int, default=48)
    ap.add_argument("--noise-frames", type=int, default=24)
    ap.add_argument("--out", default=None,
                    help="JSON path (default results/roc_torch.json; "
                         "build/ with --cpu)")
    ap.add_argument("--png", default=None,
                    help="also draw the curves here (needs matplotlib)")
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = artifact_path("roc_torch.json", args.cpu)
    if args.png:
        require_matplotlib("--png")
    report = run(args, pick_device(args.cpu))
    write_json(args.out, report)
    if args.png:
        plot(report, args.png)
    return report


if __name__ == "__main__":
    main()
