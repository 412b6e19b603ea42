"""Pfa delta check for CfarParams.means_impl="matmul" (the banded-stencil
window means) vs the default shift-add formulation — port of
``scripts/run_pfa_means_ab.py``.

The two implementations differ only in f32 summation order inside each
reference window (``ops/cfar.py::lead_trail_means_matmul``), so the
detector's false-alarm behavior must be statistically identical. Both
impls are fed the SAME draws and their per-threshold exceedance counts are
compared cell-for-cell:

1. exponential-fed validation (iid unit-exponential cells, numpy's
   ``default_rng(0)`` as JAX's): per-T hit counts for shift vs matmul on
   identical cubes + the analytic GOCA Pfa;
2. operating point: pure-noise frames through the stream pipeline (AWGN
   -> DBF -> PC -> MTD -> pair-sum maps) at the reference T=8 plus the
   measurable transition region, both impls on the same frames.

    python -m radar_tpu_torch.scripts.run_pfa_means_ab [--cpu] [--small]
        [--exp-frames 12] [--frames 12] [--out PATH]

Runs on the card by default (the JAX script forces the CPU unless
``--tpu``; the port has ``--cpu`` instead) at the full config
(``--small``: the small one). Writes
``results/pfa_matmul_recheck_torch.json`` (``build/`` with ``--cpu`` or
``--small``) with the card's name and power limit and the wall time.
Reference semantics: fun_process_single_frame.m:172-223 (window means),
threshold T_CFAR=8 at :178.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ._common import artifact_path, device_record, pick_device, write_json

T_FACTORS = [1.0, 1.5, 2.0, 4.0, 6.0, 8.0, 10.0, 12.0]
SEED = 20260821


def run(args, device) -> dict:
    from ..config.params import full_config, small_test_config
    from ..ops.cfar_analysis import analytic_pfa_goca2d, count_exceedances_2d
    from ..pipeline.driver import trial_seed
    from ..waveform.precompute import precompute
    from .run_pfa import make_noise_maps

    cfg = small_test_config() if args.small else full_config()
    params_shift = cfg.cfar
    params_matmul = dataclasses.replace(cfg.cfar, means_impl="matmul")
    assert params_shift.means_impl == "shift"
    pre = precompute(cfg)
    sig = cfg.sig
    t_start = time.perf_counter()

    # ---- 1. identical exponential draws through both impls ------------
    print("== exponential validation (same draws, both impls) ==",
          flush=True)
    shape = (sig.prt_num, pre.n_total_gate, sig.beam_num - 1)
    rng = np.random.default_rng(0)
    tot_s = torch.zeros(len(T_FACTORS), dtype=torch.int64, device=device)
    tot_m = torch.zeros_like(tot_s)
    n_cells = 0
    for _ in range(args.exp_frames):
        x = torch.as_tensor(rng.exponential(size=shape).astype(np.float32),
                            device=device)
        cs, ns = count_exceedances_2d(x, params_shift, T_FACTORS)
        cm, _ = count_exceedances_2d(x, params_matmul, T_FACTORS)
        tot_s += cs
        tot_m += cm
        n_cells += int(ns)
    tot_s, tot_m = tot_s.cpu().numpy(), tot_m.cpu().numpy()
    exp_rows = []
    for i, t in enumerate(T_FACTORS):
        a = analytic_pfa_goca2d(t, cfg.cfar)
        ms, mm = tot_s[i] / n_cells, tot_m[i] / n_cells
        exp_rows.append({
            "t": t, "hits_shift": int(tot_s[i]), "hits_matmul": int(tot_m[i]),
            "count_delta": int(tot_m[i] - tot_s[i]),
            "pfa_shift": float(ms), "pfa_matmul": float(mm), "analytic": a,
            "ratio_matmul_vs_analytic": float(mm / a) if a > 0 else None})
        print(f"  T={t:5.1f}: shift {int(tot_s[i]):>9} matmul "
              f"{int(tot_m[i]):>9} (delta {int(tot_m[i] - tot_s[i]):+d}) "
              f"analytic {a:.3e}", flush=True)

    # ---- 2. operating point on real pipeline noise, same frames -------
    print("== operating point (pure-noise stream frames, both impls) ==",
          flush=True)
    noise_maps = make_noise_maps(cfg, pre, device)
    t0 = time.perf_counter()
    cs = torch.zeros(len(T_FACTORS), dtype=torch.int64, device=device)
    cm = torch.zeros_like(cs)
    ns = 0
    for f in range(args.frames):
        maps = noise_maps(trial_seed(SEED, 0, f))
        a, n = count_exceedances_2d(maps, params_shift, T_FACTORS)
        b, _ = count_exceedances_2d(maps, params_matmul, T_FACTORS)
        cs += a
        cm += b
        ns += int(n)
    cs, cm = cs.cpu().numpy(), cm.cpu().numpy()
    print(f"  {args.frames} frames in {time.perf_counter() - t0:.1f}s "
          f"({ns / 1e6:.1f}M cells)", flush=True)
    op_rows = []
    for i, t in enumerate(T_FACTORS):
        op_rows.append({"t": t, "hits_shift": int(cs[i]),
                        "hits_matmul": int(cm[i]),
                        "count_delta": int(cm[i] - cs[i])})
        print(f"  T={t:5.1f}: shift {int(cs[i]):>9} matmul {int(cm[i]):>9} "
              f"(delta {int(cm[i] - cs[i]):+d})", flush=True)
    i8 = T_FACTORS.index(8.0)
    return {
        "device": device_record(device),
        "config": "small" if args.small else "full",
        "what": "Pfa delta of CfarParams.means_impl='matmul' vs 'shift', "
                "both impls on IDENTICAL draws",
        "cfar": {"method": cfg.cfar.method, "ref_r": cfg.cfar.ref_cells_r,
                 "guard_r": cfg.cfar.guard_cells_r,
                 "ref_v": cfg.cfar.ref_cells_v,
                 "guard_v": cfg.cfar.guard_cells_v},
        "exponential_validation": {
            "t_factors": T_FACTORS, "frames": args.exp_frames,
            "cells": n_cells, "rows": exp_rows},
        "sim_path_operating": {
            "t_factors": T_FACTORS, "frames": args.frames,
            "cells": ns, "rows": op_rows,
            "t8_hits_shift": int(cs[i8]), "t8_hits_matmul": int(cm[i8]),
            "t8_pfa_ub95_matmul": (int(cm[i8]) + 3) / ns},
        "wall_s": round(time.perf_counter() - t_start, 3),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host")
    ap.add_argument("--small", action="store_true",
                    help="shrunk config (host smoke; the JAX script has "
                         "the full config only)")
    ap.add_argument("--exp-frames", type=int, default=12)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--out", default=None,
                    help="JSON path (default results/pfa_matmul_recheck_"
                         "torch.json; build/ with --cpu or --small)")
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = artifact_path("pfa_matmul_recheck_torch.json",
                                 args.cpu or args.small)
    report = run(args, pick_device(args.cpu))
    write_json(args.out, report)
    return report


if __name__ == "__main__":
    main()
