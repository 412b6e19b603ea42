"""Measure the CFAR false-alarm rate and calibrate it against analytic
expectation — port of ``scripts/run_pfa.py``, the Pfa half of the
BASELINE "CFAR Pd at fixed Pfa" metric.

The reference never measures Pfa: it fixes T_CFAR=8
(fun_process_single_frame.m:178, main_plot_snr_vs_angle_error.m:53-55) and
relies on the amplitude-domain threshold being deep in the tail. This
script writes the JAX artifact's three sections:

1. ``exponential_validation`` — both CFAR families fed iid unit-exponential
   (square-law) cells at T in {4,6,8,10,12}, measured rate vs the exact
   analytic Pfa (``ops/cfar_analysis.py`` quadrature; closed-form CA/GO
   cross-checks included). The draws are numpy's
   (``default_rng(0)``), the same cells as JAX's.

2. ``sim_path_operating`` — pure-noise frames through the stream pipeline
   (per-channel AWGN -> DBF -> PC -> MTD -> adjacent-beam pair-sum maps)
   swept over threshold factors; at T=8 the rule-of-three 95% upper bound
   on Pfa is recorded.

3. ``realdata_path_operating`` — the same noise frames through the
   segmented 1D CA-GO CFAR (clutter band excluded), same treatment.

    python -m radar_tpu_torch.scripts.run_pfa [--cpu] [--small]
        [--frames 48] [--exp-frames 24] [--out PATH]

Runs on the card (``--cpu`` on the host) at the full config; writes
``results/pfa_calibration_torch.json`` (``build/`` with ``--cpu`` or
``--small``) with the card's name and power limit and the wall time.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ._common import artifact_path, device_record, pick_device, write_json

T_VALIDATE = [4.0, 6.0, 8.0, 10.0, 12.0]
T_OPERATE = [1.0, 1.25, 1.5, 1.75, 2.0, 2.5, 3.0, 4.0, 8.0]
SEED = 20260820


def make_noise_maps(cfg, pre, device):
    """``maps(seed)``: the pair-sum maps [V, G, pairs] of one pure-noise
    frame of the stream pipeline — CN(0, P_NOISE_FLOOR) channel noise from
    a generator seeded with ``seed``, DBF, the matmul PC and MTD (f32)."""
    from ..ops.cfar import pair_sum_maps
    from ..ops.dbf import dbf
    from ..ops.mtd import make_mtd_matrix, mtd_matmul
    from ..ops.pulse_compression import (make_matmul_plan,
                                         pulse_compress_matmul, to_device)
    from ..sim.echo import add_noise, seeded_generator

    sig = cfg.sig
    mplan = to_device(make_matmul_plan(pre), device)
    mtd_mat = torch.as_tensor(make_mtd_matrix(
        pre.mtd_win, sig.prt_num, cfg.mtd_fft_len)).to(device,
                                                        torch.complex64)
    zeros = torch.zeros((sig.prt_num, sig.point_prt, sig.channel_num),
                        dtype=torch.complex64, device=device)

    def maps(seed: int) -> torch.Tensor:
        noise = add_noise(zeros, seeded_generator(seed, device))
        beams = dbf(noise, pre.dbf_w, cfg.dbf_variant)
        return pair_sum_maps(mtd_matmul(pulse_compress_matmul(beams, mplan),
                                        mtd_mat))

    return maps


def analytic_columns(cfg) -> dict:
    """The exponential-cell analytic Pfa of both detector families at
    ``T_VALIDATE`` and the closed-form CA/GO cross-checks: the artifact's
    deterministic columns."""
    from ..ops.cfar_analysis import (analytic_pfa_ca_closed_form,
                                     analytic_pfa_exponential,
                                     analytic_pfa_go_closed_form,
                                     analytic_pfa_goca2d)

    n1 = cfg.cfar1d.ref_cells
    return {
        "sim_2d": [analytic_pfa_goca2d(t, cfg.cfar) for t in T_VALIDATE],
        "realdata_1d": [analytic_pfa_exponential(t, [n1, n1],
                                                 cfg.cfar1d.method)
                        for t in T_VALIDATE],
        "closed_form_cross_checks": {
            "ca_2n": {f"T={t}": {
                "closed": analytic_pfa_ca_closed_form(t, 2 * n1),
                "quadrature": analytic_pfa_exponential(t, [n1, n1], "CA")}
                for t in T_VALIDATE},
            "go_gandhi_kassam": {f"T={t}": {
                "closed": analytic_pfa_go_closed_form(t, n1),
                "quadrature": analytic_pfa_exponential(t, [n1, n1], "GO")}
                for t in T_VALIDATE}}}


def run(args, device) -> dict:
    from ..config.params import full_config, small_test_config
    from ..ops.cfar_analysis import (count_exceedances_1d_interior,
                                     count_exceedances_2d,
                                     count_exceedances_realdata)
    from ..pipeline.driver import trial_seed
    from ..pipeline.stages import _delta_v_bin
    from ..waveform.precompute import precompute

    cfg = small_test_config() if args.small else full_config()
    pre = precompute(cfg)
    sig = cfg.sig
    t_start = time.perf_counter()
    report = {"device": device_record(device),
              "config": "small" if args.small else "full",
              "cfar_2d": {"method": cfg.cfar.method,
                          "ref_r": cfg.cfar.ref_cells_r,
                          "guard_r": cfg.cfar.guard_cells_r,
                          "ref_v": cfg.cfar.ref_cells_v,
                          "guard_v": cfg.cfar.guard_cells_v},
              "cfar_1d": {"method": cfg.cfar1d.method,
                          "ref": cfg.cfar1d.ref_cells,
                          "guard": cfg.cfar1d.guard_cells}}

    # ---- 1. exponential-fed validation vs analytic --------------------
    print("== exponential validation ==", flush=True)
    shape = (sig.prt_num, pre.n_total_gate, sig.beam_num - 1)
    rng = np.random.default_rng(0)
    tot2 = torch.zeros(len(T_VALIDATE), dtype=torch.int64, device=device)
    tot1 = torch.zeros_like(tot2)
    nv2 = nv1 = 0
    for _ in range(args.exp_frames):
        x = torch.as_tensor(rng.exponential(size=shape).astype(np.float32),
                            device=device)
        a, b = count_exceedances_2d(x, cfg.cfar, T_VALIDATE)
        tot2 += a
        nv2 += int(b)
        a, b = count_exceedances_1d_interior(x, cfg.cfar1d, T_VALIDATE)
        tot1 += a
        nv1 += int(b)
    tot2, tot1 = tot2.cpu().numpy(), tot1.cpu().numpy()
    ana = analytic_columns(cfg)
    val = {"t_factors": T_VALIDATE, "cells_2d": nv2, "cells_1d": nv1,
           "sim_2d": [], "realdata_1d": [],
           "closed_form_cross_checks": ana["closed_form_cross_checks"]}
    for i, t in enumerate(T_VALIDATE):
        a2, a1 = ana["sim_2d"][i], ana["realdata_1d"][i]
        m2, m1 = tot2[i] / nv2, tot1[i] / nv1
        val["sim_2d"].append({"t": t, "hits": int(tot2[i]),
                              "measured": float(m2), "analytic": a2,
                              "ratio": float(m2 / a2) if a2 else None})
        val["realdata_1d"].append({"t": t, "hits": int(tot1[i]),
                                   "measured": float(m1), "analytic": a1,
                                   "ratio": float(m1 / a1) if a1 else None})
        print(f"  T={t:5.1f}: 2D {m2:.3e} vs {a2:.3e} "
              f"(x{m2 / a2:.3f})   1D {m1:.3e} vs {a1:.3e} "
              f"(x{m1 / a1:.3f})", flush=True)
    report["exponential_validation"] = val

    # ---- 2+3. operating-point curves on real pipeline noise -----------
    print("== operating-point measurement (pure-noise frames) ==",
          flush=True)
    noise_maps = make_noise_maps(cfg, pre, device)
    splits = sig.point_prt_segments
    dvb = _delta_v_bin(sig)
    c2 = torch.zeros(len(T_OPERATE), dtype=torch.int64, device=device)
    cr = torch.zeros_like(c2)
    n2 = nr = 0
    t0 = time.perf_counter()
    for f in range(args.frames):
        maps = noise_maps(trial_seed(SEED, 0, f))
        a, b = count_exceedances_2d(maps, cfg.cfar, T_OPERATE)
        c2 += a
        n2 += int(b)
        a, b = count_exceedances_realdata(maps, cfg.cfar1d, splits, dvb,
                                          T_OPERATE)
        cr += a
        nr += int(b)
    c2, cr = c2.cpu().numpy(), cr.cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"  {args.frames} frames in {dt:.1f}s "
          f"({n2 / 1e6:.1f}M 2D cells, {nr / 1e6:.1f}M 1D cells)",
          flush=True)

    def curve(counts, n_cells):
        rows = []
        for t, c in zip(T_OPERATE, counts):
            c = int(c)
            rows.append({"t": t, "hits": c, "pfa": c / n_cells,
                         "pfa_ub95": ((c + 3) / n_cells) if c < 10
                         else None})
        return rows

    i8 = T_OPERATE.index(8.0)
    report["sim_path_operating"] = {
        "t_factors": T_OPERATE, "frames": args.frames, "cells": n2,
        "curve": curve(c2, n2),
        "t8_hits": int(c2[i8]), "t8_pfa_ub95": (int(c2[i8]) + 3) / n2,
        "note": "amplitude-domain pair-sum cells; T=8 is ~10 sigma on a "
                "Rayleigh-sum cell, analytically ~1e-22 per cell"}
    report["realdata_path_operating"] = {
        "t_factors": T_OPERATE, "frames": args.frames, "cells": nr,
        "curve": curve(cr, nr),
        "t8_hits": int(cr[i8]), "t8_pfa_ub95": (int(cr[i8]) + 3) / nr}
    for name, c, n in (("sim", c2, n2), ("realdata", cr, nr)):
        s = "  ".join(f"T={t}:{int(ci) / n:.2e}"
                      for t, ci in zip(T_OPERATE, c))
        print(f"  {name}: {s}", flush=True)
    print(f"  T=8: sim {int(c2[i8])} hits / {n2} cells "
          f"(Pfa < {(int(c2[i8]) + 3) / n2:.2e} @95%), "
          f"realdata {int(cr[i8])} hits", flush=True)
    report["wall_s"] = {"total": round(time.perf_counter() - t_start, 3),
                        "operating_frames": round(dt, 3)}
    write_json(args.out, report)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host")
    ap.add_argument("--small", action="store_true",
                    help="shrunk config (host smoke)")
    ap.add_argument("--frames", type=int, default=48,
                    help="pure-noise frames for the operating-point curves")
    ap.add_argument("--exp-frames", type=int, default=24,
                    help="exponential full-cube draws for the validation")
    ap.add_argument("--out", default=None,
                    help="JSON path (default results/pfa_calibration_"
                         "torch.json; build/ with --cpu or --small)")
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = artifact_path("pfa_calibration_torch.json",
                                 args.cpu or args.small)
    return run(args, pick_device(args.cpu))


if __name__ == "__main__":
    main()
