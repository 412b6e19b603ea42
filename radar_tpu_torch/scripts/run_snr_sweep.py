"""Monte-Carlo SNR sweep driver — port of ``scripts/run_snr_sweep.py``,
the framework's equivalent of the reference's
``main_plot_snr_vs_angle_error.m``: monopulse angle-error sigma and Pd vs
SNR with the analytic |k|*sqrt(2)/sqrt(SNR) bound.

    python -m radar_tpu_torch.scripts.run_snr_sweep [--trials 100] [--cpu]
        [--small] [--snr=-10:2:30] [--lowrank --bf16 --rbg | --prng]
        [--json PATH] [--out sweep.png]

Runs on the card (``--cpu`` runs the plain versions on the host). Writes
the JAX script's ``--json`` keys, plus the card's name and power limit,
the wall time and the kernels' launches, to ``--json`` (default
``results/snr_sweep_torch.json``; ``build/`` with ``--cpu`` or
``--small``). ``--out`` draws the figure (needs matplotlib). ``--rbg`` is
recorded and selects nothing: the port's draws come from a
``torch.Generator`` or a Philox kernel. ``--dp`` is refused: the CLIs'
data-parallel sweep is ROADMAP Queue 1 item 14.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ._common import (artifact_path, device_record, kernel_launches,
                      launches_since, pick_device, require_matplotlib,
                      write_json)

DP_REFUSAL = ("--dp is not ported: the CLIs' data-parallel runs wait for "
              "ROADMAP Queue 1 item 14 (the port's mesh takes its ranks "
              "from parallel.multihost.run_ranks)")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=100)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the host")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--channels", type=int, default=None,
                    help="use scaled_config(channels, pulses) — BASELINE "
                         "config 3 is --channels 64 --pulses 256 (the "
                         "synthesized Hamming bank + self-calibrated K "
                         "slopes, config/assets.py)")
    ap.add_argument("--pulses", type=int, default=256)
    ap.add_argument("--fused", action="store_true",
                    help="fused synth+DBF beam-space path "
                         "(cfg.fused_synth_dbf)")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 precision for the MTD/PC matmuls")
    ap.add_argument("--lowrank", action="store_true",
                    help="rank-K signal RDM + post-MTD noise mixing")
    ap.add_argument("--rbg", action="store_true",
                    help="recorded only: noise_prng selects nothing in "
                         "the port")
    ap.add_argument("--prdm", action="store_true",
                    help="noise-RDM kernel K1 on torch-drawn planes "
                         "(noise_rdm_impl='pallas')")
    ap.add_argument("--uniform", action="store_true",
                    help="uniform white-noise rails for the kernel's "
                         "noise-RDM route (cfg.noise_dist='uniform')")
    ap.add_argument("--prng", action="store_true",
                    help="K1 draws its own noise (Philox; "
                         "cfg.noise_rdm_impl='pallas_prng'; implies "
                         "uniform rails)")
    ap.add_argument("--dp", type=int, default=None,
                    help="refused: ROADMAP Queue 1 item 14")
    ap.add_argument("--batch", type=int, default=16,
                    help="trials copied to the host at once")
    ap.add_argument("--truth-el", type=float, default=None,
                    help="truth elevation in deg (default: the harness "
                         "default 10 deg — only valid inside the beam "
                         "bank; the 64-ch synthesized bank spans "
                         "-16..+3.2 deg, so BASELINE config 3 should use "
                         "an in-bank pair crossover, e.g. -0.8)")
    ap.add_argument("--truth-range", type=float, default=10000.0,
                    help="truth range in m (reference: 10 km)")
    ap.add_argument("--out", default=None,
                    help="draw the sigma/Pd figure here (needs "
                         "matplotlib)")
    ap.add_argument("--json", default=None,
                    help="the sweep arrays' JSON (default results/"
                         "snr_sweep_torch.json; build/ with --cpu or "
                         "--small)")
    ap.add_argument("--snr", default="-10:2:30",
                    help="start:step:stop in dB (MATLAB colon syntax); "
                         "use --snr=-10:2:30 form for negative starts")
    args = ap.parse_args(argv)
    if args.json is None:
        args.json = artifact_path("snr_sweep_torch.json",
                                  args.cpu or args.small)
    return args


def make_config(args):
    """The JAX script's config from its flags (``:89-118``)."""
    from ..config.params import full_config, scaled_config, small_test_config

    if args.channels is not None:
        cfg = scaled_config(channels=args.channels, pulses=args.pulses)
    else:
        cfg = small_test_config() if args.small else full_config()
    if args.fused:
        cfg = cfg.replace(fused_synth_dbf=True)
    if args.bf16:
        cfg = cfg.replace(matmul_precision="bf16")
    if args.lowrank:
        cfg = cfg.replace(fused_synth_dbf=True, lowrank_rdm=True)
    if args.rbg:
        cfg = cfg.replace(noise_prng="rbg")
    if args.prdm:
        cfg = cfg.replace(fused_synth_dbf=True, lowrank_rdm=True,
                          noise_rdm_impl="pallas")
    if args.uniform:
        cfg = cfg.replace(noise_dist="uniform")
    if args.prng:
        cfg = cfg.replace(fused_synth_dbf=True, lowrank_rdm=True,
                          noise_rdm_impl="pallas_prng",
                          noise_dist="uniform")
    return cfg


def post_gain_bound(cfg, pre, snr_db, theory_bound) -> dict:
    """The reference bound |k|*sqrt(2)/sqrt(SNR_raw) (main_plot_snr_vs_
    angle_error.m:303-309) is vacuous at the scaled geometries' raw-SNR
    operating points; this also quotes it at the post-integration SNR the
    monopulse ratio sees: raw SNR x DBF array gain x PC pulse-compression
    gain x MTD coherent-integration gain, each with its window's taper
    efficiency (sum w)^2 / (N sum w^2). Float64 numpy, as JAX's
    ``:145-177``."""
    def eff(w):
        w = np.abs(np.asarray(w)).astype(float)
        return float(w.sum() ** 2 / (len(w) * (w * w).sum()))

    g_dbf = cfg.sig.channel_num * float(np.mean(
        [eff(row) for row in np.asarray(pre.dbf_w)]))
    g_pc = len(pre.mf_long_win) * eff(pre.mf_long_win)
    g_mtd = cfg.sig.prt_num * eff(pre.mtd_win)
    gain = g_dbf * g_pc * g_mtd
    snr_lin = 10.0 ** (np.asarray(snr_db, float) / 10.0)
    kabs = float(theory_bound[0] * np.sqrt(snr_lin[0]) / np.sqrt(2.0))
    return {
        "theory_bound_raw_snr_deg": [float(x) for x in theory_bound],
        "theory_bound_post_gain_deg":
            [float(kabs * np.sqrt(2.0) / np.sqrt(s * gain))
             for s in snr_lin],
        "integration_gain_db": round(10 * np.log10(gain), 2),
        "bound_note": (
            "raw-SNR bound is the reference's form and is vacuous at "
            "these raw operating points; the post-gain bound evaluates it "
            f"at raw SNR + {10 * np.log10(gain):.1f} dB (DBF x long-pulse "
            "PC x MTD, taper efficiencies included)"),
    }


def run(args, device) -> dict:
    """The sweep of ``args`` on ``device``."""
    from ..pipeline.montecarlo import snr_sweep
    from ..sim.scenario import TargetBatch
    from ..waveform.precompute import precompute

    start, step, stop = (float(x) for x in args.snr.split(":"))
    snr_vec = np.arange(start, stop + 1e-9, step)
    cfg = make_config(args)
    pre = precompute(cfg)
    truth = None
    if args.truth_el is not None:
        truth = TargetBatch.make([args.truth_range], [20.0],
                                 [args.truth_el], [0.0])
    before = kernel_launches()
    t0 = time.perf_counter()
    res = snr_sweep(cfg, snr_db_vector=snr_vec, num_trials=args.trials,
                    truth=truth, progress=True, batch_size=args.batch,
                    precomp=pre, device=device)
    wall = time.perf_counter() - t0
    launches = launches_since(before)
    print(f"\nsweep done in {wall:.1f}s")
    for i, s in enumerate(res.snr_db):
        print(f"  SNR {s:+6.1f} dB: Pd={res.detection_probability[i]:5.2f} "
              f"sigma={res.angle_error_std[i]:8.4f} deg "
              f"(bound {res.theory_bound[i]:.4f})")
    bound_fields = {"theory_bound_deg": [float(x)
                                         for x in res.theory_bound]}
    if args.channels is not None:
        bound_fields = post_gain_bound(cfg, pre, res.snr_db,
                                       res.theory_bound)
    report = {
        "config": (f"scaled {args.channels}ch x {args.pulses}p"
                   if args.channels is not None
                   else "small" if args.small else "full"),
        "pipeline": {"fused": bool(cfg.fused_synth_dbf),
                     "lowrank": bool(cfg.lowrank_rdm),
                     "bf16": cfg.matmul_precision == "bf16",
                     "rbg": cfg.noise_prng == "rbg",
                     "noise_rdm_impl": cfg.noise_rdm_impl,
                     "noise_dist": cfg.noise_dist,
                     "fused_pallas_kernel":
                         str(cfg.noise_rdm_impl).startswith("pallas")},
        "snr_db": [float(x) for x in res.snr_db],
        "angle_error_std_deg": [float(x) for x in res.angle_error_std],
        "detection_probability": [float(x)
                                  for x in res.detection_probability],
        **bound_fields,
        "trials": args.trials,
        "truth": {"range_m": args.truth_range,
                  "elevation_deg": (args.truth_el
                                    if args.truth_el is not None else 10.0),
                  "velocity_ms": 20.0},
        "device": device_record(device),
        "wall_s": round(wall, 3),
        "trials_per_s": round(args.trials * len(snr_vec) / wall, 3),
        "launches": launches,
    }
    write_json(args.json, report)
    if args.out:
        from ..viz.plots import plot_snr_sweep

        print("figure:", plot_snr_sweep(res, args.out))
    return report


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.dp is not None:
        raise SystemExit(DP_REFUSAL)
    if args.out:
        require_matplotlib("--out")
    return run(args, pick_device(args.cpu))


if __name__ == "__main__":
    main()
