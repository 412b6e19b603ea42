"""Per-stage benchmarks of the library's device stages — port of
``scripts/run_kernel_bench.py`` (BASELINE.json's "range-Doppler
samples/s/chip" for the DBF and matched-filter stages, MUSIC at 128
elements): its five arms at the full frame's shapes.

    python -m radar_tpu_torch.scripts.run_kernel_bench [--cpu] [--small]
        [--out PATH]

Arms (JAX's ``scripts/run_kernel_bench.py:112-155``): DBF 16 channels ->
13 beams, the matmul pulse compression, the 332-point MTD, MUSIC 1D at 128
elements x 1024 snapshots on the 3600-point grid, and MUSIC 2D on the
16x8 URA's 481 x 281 grid (0.25 deg) with the peaks picked on the device.
Each call's output is reduced nonlinearly (sum |y|, which no stage can be
factored through) and the reduction is timed with it.

On the card: CUDA events around 20 calls queued behind a sleep
kernel (the card busy, so the events hold device time while the host
keeps ahead), the median of 5 such windows a call, and the host's ms a
call. ``--cpu`` times the plain PyTorch stages with the host clock, one
window (a smoke; no device metric). Writes ``results/kernel_bench_torch.json`` (``build/``
with ``--cpu`` or ``--small``) with the card's name and power limit beside
every number. ``--small``: the small config's widths and a 16-element,
128-snapshot MUSIC (a 4 x 4 URA on a 1-degree grid).
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np

from ._common import artifact_path, device_record, pick_device, write_json

SLEEP_CYCLES = 4_000_000      # torch.cuda._sleep ahead of a window: ~2 ms
REPS = 20                     # calls a timed window


def time_ms(fn, device) -> dict:
    """Median ms a call of ``fn`` over 5 runs of ``REPS`` calls, CUDA events
    behind a sleep kernel, and the host's ms a call, after two warm-up
    calls; on the CPU one run's host clock (a smoke, no device metric)."""
    import torch

    fn(), fn()
    dev, host = [], []
    for _ in range(5 if device.type == "cuda" else 1):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            a.record()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / REPS)
        if device.type == "cuda":
            b.record()
            b.synchronize()
            dev.append(a.elapsed_time(b) / REPS)
    out = {"host_ms": statistics.median(host)}
    if dev:
        out["ms"] = statistics.median(dev)
    return out


def arms(cfg, device, small: bool) -> dict:
    """``{name: (call, extra(ms) -> dict)}``: the five stages on inputs
    drawn once on ``device``, each call ending in sum |y|."""
    import torch

    from ..doa.music import (covariance, music_spectrum_1d, noise_subspace,
                             regional_max_peaks_2d, steering_ura)
    from ..ops.dbf import dbf
    from ..ops.mtd import mtd
    from ..ops.pulse_compression import (make_matmul_plan,
                                         pulse_compress_matmul, to_device)
    from ..waveform.precompute import precompute

    pre = precompute(cfg)
    p, s, c, b, g = (cfg.sig.prt_num, cfg.sig.point_prt,
                     cfg.sig.channel_num, cfg.sig.beam_num,
                     pre.n_total_gate)
    gen = torch.Generator(device=device).manual_seed(0)
    draw = lambda *shape: torch.randn(shape, dtype=torch.complex64,
                                      generator=gen, device=device)
    r_sum = lambda y: y.abs().sum()
    mplan = to_device(make_matmul_plan(pre), device)
    x_iq, x_b, x_pc = draw(p, s, c), draw(p, s, b), draw(p, g, b)
    n_el, n_snap, nx, ny = (16, 128, 4, 4) if small else (128, 1024, 16, 8)
    step2 = 1.0 if small else 0.25
    x_1d, x_2d = draw(n_el, n_snap), draw(nx * ny, n_snap // 2)
    d, wl = cfg.sig.wavelength / 2, cfg.sig.wavelength
    scan = np.arange(-90.0, 90.0, 0.05)
    az2 = np.arange(-60.0, 60.0 + 1e-9, step2)
    el2 = np.arange(10.0, 80.0 + 1e-9, step2)
    a2 = torch.as_tensor(steering_ura(az2, el2, nx, ny, 0.5)).to(
        device, torch.complex64)

    def music2d():
        en = noise_subspace(covariance(x_2d), 3)
        spec = (1.0 / ((en.mH @ a2).abs().pow(2).sum(0) + 1e-30)).reshape(
            len(az2), len(el2))
        idx, vals = regional_max_peaks_2d(spec, 3)
        return (vals + idx.float()).sum()

    return {
        f"dbf_{c}ch_{b}beam": (
            lambda: r_sum(dbf(x_iq, pre.dbf_w, cfg.dbf_variant)),
            lambda ms: {"input_msamples_per_s": p * s * c / ms / 1e3,
                        "gflops": 8 * p * s * c * b / ms / 1e6}),
        "pulse_compression_matmul": (
            lambda: r_sum(pulse_compress_matmul(x_b, mplan)),
            lambda ms: {"output_msamples_per_s": p * g * b / ms / 1e3}),
        f"mtd_{p}pt": (
            lambda: r_sum(mtd(x_pc, pre.mtd_win, None)),
            lambda ms: {"msamples_per_s": p * g * b / ms / 1e3}),
        f"music_{n_el}el_{n_snap}snap_{len(scan)}grid": (
            lambda: r_sum(music_spectrum_1d(covariance(x_1d), 3, scan, d,
                                            wl)),
            lambda ms: {}),
        f"music2d_{nx * ny}el_{nx}x{ny}ura_{len(az2)}x{len(el2)}grid": (
            music2d, lambda ms: {"grid_points": len(az2) * len(el2)}),
    }


def main(argv=None) -> dict:
    import torch

    from ..config.params import full_config, small_test_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="time the plain stages on the host")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out_path = args.out or artifact_path("kernel_bench_torch.json",
                                         args.cpu or args.small)
    device = pick_device(args.cpu)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = small_test_config() if args.small else full_config()
    card = device_record(device)
    results = {"device": card,
               "method": ("CUDA events around 20 calls behind a sleep "
                          "kernel (busy card), median of 5 windows; each "
                          "call ends in sum |y|" if device.type == "cuda"
                          else "host clock around 20 calls, one window "
                               "(CPU, plain PyTorch; no device metric)"),
               "reps": REPS}
    for name, (fn, extra) in arms(cfg, device, args.small).items():
        t = time_ms(fn, device)
        ms = t.get("ms", t["host_ms"])
        results[name] = {**t, **{k: round(v, 1)
                                 for k, v in extra(ms).items()},
                         "device": card}
        print(name, results[name], flush=True)
    write_json(out_path, results)
    return results


if __name__ == "__main__":
    main()
