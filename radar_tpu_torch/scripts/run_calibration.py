"""Offline calibration CLI — port of ``scripts/run_calibration.py``, the
framework's equivalent of the reference's L7 tool scripts
(``plot_beam_patterns.m``, ``calibrate_all_monopulse_slopes.m``): evaluate
the DBF bank's beam patterns, extract the pointing angles, calibrate the
monopulse K-slope LUT, and print both in paste-ready form (the reference
prints the LUT for manual paste into the drivers,
calibrate_all_monopulse_slopes.m:84-90; here the same values feed
waveform/precompute automatically, and this tool is for inspection and
re-derivation).

    python -m radar_tpu_torch.scripts.run_calibration [--cpu]
        [--fc-mhz 9450] [--channels 16] [--reference-quirks]
        [--procedure self-consistent|reference] [--out patterns.png]
        [--json PATH]

The calibration is host numpy (``doa/calibrate.py``), as JAX's; like every
port script it asks for the card unless ``--cpu`` is given. It writes the
printed LUTs and crossovers, with the card's name and power limit, to
``--json`` (default ``results/calibration_torch.json``; ``build/`` with
``--cpu``); ``--out`` draws the beam patterns (needs matplotlib).
"""

from __future__ import annotations

import argparse

import numpy as np

from ._common import (artifact_path, device_record, pick_device,
                      require_matplotlib, write_json)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host only")
    ap.add_argument("--fc-mhz", type=float, default=None,
                    help="evaluate patterns at this carrier (the reference "
                         "plot script's quirk uses 9500 vs the system's "
                         "9450 MHz, plot_beam_patterns.m:20)")
    ap.add_argument("--channels", type=int, default=16,
                    help="16 = measured CSV bank; other values synthesize "
                         "a bank (8/64/128-ch configs)")
    ap.add_argument("--out", default=None,
                    help="draw the beam patterns here (needs matplotlib)")
    ap.add_argument("--json", default=None,
                    help="the LUTs' JSON (default results/"
                         "calibration_torch.json; build/ with --cpu)")
    ap.add_argument("--reference-quirks", action="store_true",
                    help="quirk-faithful plot_beam_patterns.m procedure "
                         "(fliplr'd weights, fc=9500 MHz, 1-based element "
                         "indices, no conj) — reproduces the pasted "
                         "beam_angles_deg LUT exactly")
    ap.add_argument("--procedure", choices=("self-consistent", "reference"),
                    default="self-consistent",
                    help="'self-consistent' = magnitude-ratio calibration "
                         "matching how the pipeline applies K; 'reference' "
                         "= calibrate_all_monopulse_slopes.m procedure "
                         "(complex ratio, fliplr, +/-separation scan)")
    args = ap.parse_args(argv)
    if args.json is None:
        args.json = artifact_path("calibration_torch.json", args.cpu)
    return args


def run(args, device) -> dict:
    from ..config.params import ArrayConfig, RadarConfig, SigConfig
    from ..doa.calibrate import (beam_patterns, beam_patterns_reference,
                                 calibrate_k_slopes)
    from ..waveform.precompute import precompute

    sig = SigConfig(channel_num=args.channels,
                    beam_num=13 if args.channels >= 16
                    else args.channels - 3)
    cfg = RadarConfig(sig=sig, array=ArrayConfig(num_elements=args.channels))
    pre = precompute(cfg)
    dbf_w = np.asarray(pre.dbf_w)
    wavelength = (sig.c / (args.fc_mhz * 1e6) if args.fc_mhz
                  else sig.wavelength)

    if args.reference_quirks:
        scan, resp, peaks = beam_patterns_reference(
            dbf_w, cfg.array.element_spacing)
    else:
        scan, resp, peaks = beam_patterns(dbf_w, cfg.array.element_spacing,
                                          sig.wavelength,
                                          wavelength_override=wavelength)
    if args.procedure == "reference":
        # calibrate_all_monopulse_slopes.m: fliplr'd weights, complex field
        # ratio, scan = crossover +/- separation (doa/calibrate.py notes
        # that the reference's own LUT does not match this procedure)
        ks = calibrate_k_slopes(np.fliplr(dbf_w),
                                np.asarray(pre.beam_angles_deg),
                                cfg.array.element_spacing, wavelength,
                                ratio="complex", span_factor=1.0)
    else:
        ks = calibrate_k_slopes(dbf_w, peaks, cfg.array.element_spacing,
                                wavelength)

    fc_mhz = sig.c / wavelength / 1e6
    print(f"beams: {len(peaks)}  channels: {args.channels}  "
          f"fc: {fc_mhz:.0f} MHz")
    print("beam_angles_deg = ["
          + " ".join(f"{a:.1f}" for a in peaks) + "]")
    print("k_slopes_LUT   = ["
          + " ".join(f"{k:.4f}" for k in ks) + "]")
    # crossover depth check (adjacent-beam pattern intersection level)
    pairs = []
    for p in range(len(peaks) - 1):
        mid = 0.5 * (peaks[p] + peaks[p + 1])
        i = int(np.argmin(np.abs(scan - mid)))
        lvl = 20 * np.log10(resp[p, i] / resp[p].max() + 1e-300)
        print(f"pair {p:2d}: crossover {mid:7.2f} deg  depth {lvl:6.2f} dB  "
              f"K={ks[p]:8.4f}")
        pairs.append({"pair": p, "crossover_deg": float(mid),
                      "depth_db": float(lvl), "k": float(ks[p])})
    report = {
        "what": "beam-pattern pointing angles and monopulse K-slope LUT "
                "(plot_beam_patterns.m, calibrate_all_monopulse_slopes.m)",
        "device": device_record(device),
        "channels": args.channels, "fc_mhz": float(fc_mhz),
        "procedure": args.procedure,
        "reference_quirks": bool(args.reference_quirks),
        "beam_angles_deg": [float(a) for a in peaks],
        "k_slopes_lut": [float(k) for k in ks],
        "pairs": pairs,
    }
    write_json(args.json, report)
    if args.out:
        from ..viz.plots import plot_beam_patterns_fig

        print("figure:", plot_beam_patterns_fig(
            dbf_w, cfg.array.element_spacing, sig.wavelength, args.out))
    return report


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.out:
        require_matplotlib("--out")
    return run(args, pick_device(args.cpu))


if __name__ == "__main__":
    main()
