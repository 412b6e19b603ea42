"""Operating curve of the second detector family, the real-data path's
segmented 1D CA-GO CFAR (ops/cfar1d.py): Pd(T) and Pfa(T) through the
staged pipeline (DBF -> stage 2 PC + MTD -> stage 3 segmented CFAR) in one
artifact — port of ``scripts/run_roc_realdata.py``.

    python -m radar_tpu_torch.scripts.run_roc_realdata [--trials 200]
        [--noise-frames 400] [--out PATH] [--png PATH] [--cpu]

- Pd(T): Monte-Carlo injections of a fixed target echo (gate 1500, long
  segment; 12 m/s; 12-deg physical elevation, the tests/test_realdata.py
  scene) into white gated IQ at a near-threshold amplitude, through DBF +
  stage 2; one CFAR call sweeps the vector of threshold factors on each
  trial's maps. Detection = any CFAR flag inside a +-3-gate x +-2-bin
  window of the truth cell (the detector's own output, before extraction
  capacity).
- Pfa(T): noise-only frames, the operational flag counts per T over the
  tested (non-clutter-band) cells (``count_exceedances_realdata``).

Runs on the card (``--cpu`` for a smoke run on the host's plain PyTorch)
at 64 pulses x 3404 gates x 16 channels, and writes
``results/roc_realdata_torch.json`` (``build/`` with ``--cpu``) with
Wilson 95% intervals beside every Pd; ``--png`` also draws the curves (needs matplotlib).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..config import assets
from ..config.params import RadarConfig, SigConfig
from ..ops.cfar1d import segmented_cfar_1d
from ..ops.cfar_analysis import count_exceedances_realdata
from ..ops.dbf import dbf
from ..pipeline.stages import (_delta_v_bin, _segment_pulses,
                               pair_sum_maps_realdata, stage2_mtd)
from ..utils.stats import wilson_ci
from ._common import (artifact_path, device_record, pick_device,
                      require_matplotlib, write_json)

T_SWEEP = [3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0, 12.0]
T_REF = 8.0


def run(args, device: torch.device) -> dict:
    sig = SigConfig(prt_num=64, channel_num=16, beam_num=13)
    cfg = RadarConfig(sig=sig)
    n_p, n_g, n_c = sig.prt_num, sig.n_total_gate, sig.channel_num
    dvb = _delta_v_bin(sig)
    splits = sig.point_prt_segments
    dbf_w = np.asarray(assets.dbf_coeffs())
    ts = torch.tensor(T_SWEEP, dtype=torch.float32, device=device)

    # fixed truth echo (tests/test_realdata.py scene): long-segment gate,
    # conjugate steering of the real-data DBF convention
    _, _, p3 = _segment_pulses(cfg)
    truth_gate, truth_v, el_physical = 1500, 12.0, 12.0
    dphi = (2 * np.pi * 0.0138 * np.sin(np.deg2rad(el_physical))
            / sig.wavelength)
    steer = np.exp(-1j * np.arange(n_c) * dphi)
    dop = np.exp(1j * 2 * np.pi * (2 * truth_v / sig.wavelength)
                 * np.arange(n_p) * sig.prt)
    segv = np.zeros(n_g, complex)
    segv[truth_gate:truth_gate + len(p3)] = p3
    echo = torch.as_tensor((args.amp * dop[:, None, None]
                            * segv[None, :, None] * steer[None, None, :]
                            ).astype(np.complex64), device=device)

    def front(iq):
        """T-independent: gated IQ -> sum-beam amplitude maps."""
        rdm, _ = stage2_mtd(dbf(iq, dbf_w, "realdata"), cfg)
        return pair_sum_maps_realdata(rdm)

    maps0 = front(echo)
    v0, g0, _ = np.unravel_index(int(torch.argmax(maps0)), maps0.shape)
    v0, g0 = int(v0), int(g0)
    print(f"truth cell: v_bin={v0} gate={g0} (injected gate {truth_gate})",
          flush=True)
    gen = torch.Generator(device).manual_seed(args.seed)

    def noise_cube():
        return torch.randn((n_p, n_g, n_c), dtype=torch.complex64,
                           device=device, generator=gen)

    print(f"== Pd arm: amp={args.amp} ({20 * np.log10(args.amp):+.1f} dB "
          f"per-sample), {args.trials} trials ==", flush=True)
    t0 = time.perf_counter()
    hits = torch.zeros(len(T_SWEEP), dtype=torch.int64, device=device)
    for trial in range(args.trials):
        flags, _ = segmented_cfar_1d(front(echo + noise_cube()), cfg.cfar1d,
                                     splits, dvb, threshold_factor=ts)
        hits += flags[:, v0 - 2:v0 + 3, g0 - 3:g0 + 4].flatten(1).any(dim=1)
        if (trial + 1) % args.batch == 0 or trial + 1 == args.trials:
            print(f"  {trial + 1}/{args.trials} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    pd_counts = hits.cpu().numpy()
    pd_s = time.perf_counter() - t0
    pds = pd_counts / args.trials
    for t, p in zip(T_SWEEP, pds):
        print(f"  T={t:5.1f}: Pd={p:.3f}", flush=True)

    print(f"== Pfa arm: {args.noise_frames} noise frames ==", flush=True)
    t0 = time.perf_counter()
    counts = torch.zeros(len(T_SWEEP), dtype=torch.int64, device=device)
    per_frame = 0      # tested cells a frame: the mask geometry's
    for frame in range(args.noise_frames):
        c, n = count_exceedances_realdata(front(noise_cube()), cfg.cfar1d,
                                          splits, dvb, ts)
        counts += c
        per_frame = per_frame or int(n)
        cells = per_frame * (frame + 1)
        if (frame + 1) % args.noise_batch == 0 \
                or frame + 1 == args.noise_frames:
            print(f"  {frame + 1}/{args.noise_frames} frames, "
                  f"{cells / 1e6:.0f}M cells "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    counts = counts.cpu().numpy()
    pfa_s = time.perf_counter() - t0
    pfa = counts / cells
    pfa_bound = np.where(counts > 0, pfa, 3.0 / cells)
    for t, c, p, b in zip(T_SWEEP, counts, pfa, pfa_bound):
        tag = f"{p:.3e}" if c else f"<= {b:.1e} (0 hits, 95% bound)"
        print(f"  T={t:5.1f}: Pfa={tag}", flush=True)

    pd_ci = [wilson_ci(int(c), args.trials) for c in pd_counts]
    i8 = T_SWEEP.index(T_REF)
    lo8, hi8 = pd_ci[i8]
    dev = device_record(device)
    headline = (
        f"realdata 1D CA-GO: Pd={pds[i8]:.2f} (95% CI {lo8:.2f}-{hi8:.2f}"
        f", {args.trials} trials) at Pfa"
        + (f"={pfa[i8]:.2e}" if counts[i8] else f"<={pfa_bound[i8]:.1e}")
        + f" (T={T_REF:g}, amp {args.amp} = "
          f"{20 * np.log10(args.amp):+.1f} dB/sample, 64p x 3404g x "
          f"16ch, {dev})")
    print("HEADLINE:", headline, flush=True)
    return {
        "device": dev,
        "config": "realdata staged path: DBF(realdata) -> stage2 PC+MTD "
                  "-> segmented 1D CA-GO CFAR (64 pulses x 3404 gates x "
                  "16 ch, 12 sum-beam pairs)",
        "amp": args.amp, "amp_db_per_sample": 20 * np.log10(args.amp),
        "truth_cell": [v0, g0], "seed": args.seed,
        "trials_per_t": args.trials, "noise_frames": args.noise_frames,
        "noise_cells": int(cells), "t_factors": T_SWEEP,
        "pd": [float(p) for p in pds],
        "pd_hits": [int(c) for c in pd_counts],
        "pd_ci95": [[lo, hi] for lo, hi in pd_ci],
        "pfa": [float(p) for p in pfa],
        "pfa_hits": [int(c) for c in counts],
        "pfa_95_upper_bound": [float(b) for b in pfa_bound],
        "headline": headline,
        "wall_s": {"pd_arm": pd_s, "pfa_arm": pfa_s},
        "note": "Pd counts DETECTOR flags in the truth window (before "
                "extraction capacity); Pfa counts operational flags over "
                "the tested (non-clutter-band) cells — the >= compare and "
                "edge fallback of Function_CFAR1D_sub included",
        "ref": "Function_CFAR1D_sub debug_simulated_data_processing_v2.m:"
               "467-511; fixed-T adapter main_test_with_simulated_data.m",
    }


def plot(report: dict, path: str) -> None:
    """The Pfa and Pd curves against T (needs matplotlib)."""
    try:
        import matplotlib
    except ImportError as e:
        raise SystemExit(f"--png needs matplotlib, which is missing: {e}")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ts = report["t_factors"]
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 9))
    ax1.semilogy(ts, np.maximum(report["pfa"], 0.5 / report["noise_cells"]),
                 "bo-", label="measured Pfa")
    ax1.semilogy(ts, report["pfa_95_upper_bound"], "c--",
                 label="95% upper bound")
    ax1.axvline(T_REF, color="k", ls=":", label=f"reference T={T_REF:g}")
    ax1.set_xlabel("threshold factor T")
    ax1.set_ylabel("Pfa per valid cell (1D CA-GO)")
    ax1.legend()
    ax1.grid(True)
    ax2.plot(ts, np.asarray(report["pd"]) * 100, "ms-")
    ax2.axvline(T_REF, color="k", ls=":")
    ax2.set_xlabel("threshold factor T")
    ax2.set_ylabel(f"Pd (%) at amp {report['amp']} "
                   f"({report['amp_db_per_sample']:+.1f} dB/sample)")
    ax2.set_ylim(-5, 105)
    ax2.grid(True)
    fig.suptitle(report["headline"], fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    print("figure:", path, flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the host (smoke runs)")
    ap.add_argument("--amp", type=float, default=0.018,
                    help="per-sample echo amplitude vs unit-power channel "
                         "noise (default sits in the T=8 transition)")
    ap.add_argument("--trials", type=int, default=200)
    ap.add_argument("--batch", type=int, default=50,
                    help="trials between progress lines")
    ap.add_argument("--noise-frames", type=int, default=400)
    ap.add_argument("--noise-batch", type=int, default=100,
                    help="noise frames between progress lines")
    ap.add_argument("--seed", type=int, default=20260821)
    ap.add_argument("--out", default=None,
                    help="JSON path (default results/roc_realdata_torch."
                         "json; build/ with --cpu)")
    ap.add_argument("--png", default=None,
                    help="also draw the curves here (needs matplotlib)")
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = artifact_path("roc_realdata_torch.json", args.cpu)
    if args.png:
        require_matplotlib("--png")
    report = run(args, pick_device(args.cpu))
    write_json(args.out, report)
    if args.png:
        plot(report, args.png)
    return report


if __name__ == "__main__":
    main()
