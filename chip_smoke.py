"""Smoke run of the PyTorch/CUDA port (radar_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from ``radar_tpu_torch/csrc`` with nvcc, checks
each against its plain PyTorch version at the full perf-config shapes
(16 channels x 332 pulses x 5819 samples -> RDM [13 beams, 332 Doppler,
3404 gates] -> 12 pair maps), drives the frame processor once on the
benchmark's two targets, shows through the launch counters that the frame
ran on kernels K1 and K2, and times kernels, plain versions and the frame
with CUDA events. Every phase prints one line; any failure raises and
exits non-zero. The last line is the result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA, or without the repository beside it, it fails at once.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


def _line(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def _require(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _event_ms(fn, reps: int) -> list:
    """CUDA-event times (ms) of ``reps`` calls of ``fn``."""
    import torch

    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def _time_pair(kernel, plain, reps: int = 5):
    """Median ms of ``kernel`` and ``plain``, run in turns (plain, kernel,
    kernel, plain) after one warm-up call each."""
    kernel(), plain()
    tp = _event_ms(plain, reps)
    tk = _event_ms(kernel, 2 * reps)
    tp += _event_ms(plain, reps)
    return statistics.median(tk), statistics.median(tp)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing runs on the CPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from radar_tpu_torch import _build
    from radar_tpu_torch.config.params import (PERF_OVERRIDES, perf_config,
                                               small_test_config)
    from radar_tpu_torch.ops import cfar_kernel as ck
    from radar_tpu_torch.ops import noise_rdm as nr
    from radar_tpu_torch.pipeline.frame import make_frame_processor
    from radar_tpu_torch.pipeline.lowrank import make_lowrank_stages
    from radar_tpu_torch.sim.scenario import TargetBatch
    from radar_tpu_torch.waveform.precompute import precompute

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. card, versions, build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = f"{torch.cuda.get_device_name(0)} ({smi.split(',')[-1].strip()})"
    t0 = time.perf_counter()
    for name in ("noise_rdm", "cfar"):
        _build.load(name)
    _line("build", torch=torch.__version__, cuda=torch.version.cuda,
          seconds=round(time.perf_counter() - t0, 2))
    for name, info in _build.build_info.items():
        for ln in info["log"].splitlines():
            if "Used" in ln or "spill" in ln:
                print(f"  ptxas {name}: {ln.strip()}", flush=True)

    # ---- 2. K1 at full perf shapes vs its plain version
    cfg = perf_config()
    pre = precompute(cfg)
    lr = make_lowrank_stages(cfg, pre, device=dev)
    plan, lmat = lr.rplan, lr.l_factor
    num_b = lmat.shape[0]
    truth = TargetBatch.make([3000.0, 10000.0], [20.0, 25.0], [10.0, 10.0],
                             [10.0, 15.0])
    factors = lr.signal_factors(truth)
    seed = nr.seed_words(20261016)
    planes = nr.philox_planes(plan, seed, num_b, device=dev)
    ref = nr.noise_rdm_plain(plan, lmat, planes, factors)
    k_planes = nr.noise_rdm(plan, lmat, factors, planes=planes, layout="bvg")
    k_draw = nr.noise_rdm(plan, lmat, factors, seed=seed, layout="bvg")
    torch.cuda.synchronize()
    _require(k_draw.shape == (num_b, plan.n_dop, plan.n_gates), "K1 shape")
    diff = (k_planes - ref).abs()
    rms = float(ref.abs().pow(2).mean().sqrt())
    k1_err = float(diff.max())
    rms_err = float(diff.pow(2).mean().sqrt())
    draw_vs_planes = float((k_draw - k_planes).abs().max())
    _line("K1", shape=list(k_draw.shape), max_abs_err=k1_err,
          rms_err_over_rms=rms_err / rms, draw_vs_planes_max=draw_vs_planes,
          tol="rms(err)<=1e-5*rms, |err|<=1e-4*rms+1e-5*|ref|")
    _require(bool(torch.isfinite(torch.view_as_real(k_draw)).all()),
             "K1 finite")
    _require(rms_err <= 1e-5 * rms, "K1 rms error")
    _require(bool((diff <= 1e-4 * rms + 1e-5 * ref.abs()).all()),
             "K1 element error")
    # the kernel's draws equal the plain Philox planes bit for bit
    _require(torch.equal(k_draw, k_planes), "K1 draws == plain Philox planes")

    # ---- 3. rail statistics and the noise power set by L
    rails = torch.cat([torch.cat([xr[..., s.pad_front:].reshape(-1),
                                  xi[..., s.pad_front:].reshape(-1)])
                       for s, (xr, xi) in zip(plan.segments, planes)])
    mean, var = float(rails.double().mean()), float(rails.double().var())
    noise = nr.noise_rdm(plan, lmat, seed=seed, layout="bvg")
    l2 = (lmat.abs() ** 2).sum(1).double()
    d2 = (plan.d.abs() ** 2).sum(1).double()
    h2 = torch.cat([torch.full((s.j_len,), float((s.taps.abs() ** 2).sum()),
                               device=dev) for s in plan.segments]).double()
    sl = slice(plan.segments[0].pad_front, None)
    want = (l2[:, None, None] * d2[None, :, None] * h2[None, None, :])
    power_ratio = float((noise.abs() ** 2).double()[..., sl].mean()
                        / want[..., sl].mean())
    _line("draws", samples=rails.numel(), mean=mean, var=var,
          noise_power_over_L_model=power_ratio)
    _require(abs(mean) < 5 * (0.5 / rails.numel()) ** 0.5, "rail mean")
    _require(abs(var / 0.5 - 1.0) < 0.01, "rail variance")
    _require(abs(power_ratio - 1.0) < 0.02, "noise power vs L model")

    # ---- 4. K2 at full shapes vs its plain version
    mag = k_draw.abs()
    maps_p = ck.pad_maps_qvg(mag[:-1] + mag[1:])
    num_v, num_g = plan.n_dop, plan.n_gates
    mask, rc = ck.goca_cfar_qvg(maps_p, cfg.cfar, num_g, num_v)
    mask_p, rc_p = ck.goca_cfar_qvg_plain(maps_p, cfg.cfar, num_g, num_v)
    torch.cuda.synchronize()
    mask_diff = int((mask != mask_p).sum())
    rc_diff = int((rc - rc_p).abs().max())
    k2_err = float(max(rc_diff, int(mask_diff > 0)))
    _line("K2", maps=list(maps_p.shape), hits=int(mask.sum()),
          mask_cells_differing=mask_diff, rc_max_abs_diff=rc_diff)
    _require(mask_diff == 0 and rc_diff == 0 and int(mask.sum()) > 0,
             "K2 == plain")

    # ---- 5. the main path: frame processor at the perf config
    process = make_frame_processor(cfg, pre, device=dev)
    process(1, truth)                      # warm-up outside the count
    torch.cuda.synchronize()
    nr.launch_count = 0
    ck.launch_count = 0
    res = process(20261016, truth)
    torch.cuda.synchronize()
    launches = {"K1": nr.launch_count, "K2": ck.launch_count}
    t = res.targets
    ok = t.valid.cpu().numpy()
    rows = np.stack([x.cpu().numpy()[ok] for x in
                     (t.range_m, t.velocity_ms, t.angle_deg, t.power)], 1)
    dr = float(pre.delta_r)
    dv = float(pre.velocity_axis[1] - pre.velocity_axis[0])
    found = [bool(np.any((np.abs(rows[:, 0] - r) <= 2 * dr)
                         & (np.abs(rows[:, 1] - v) <= 2 * dv)))
             for r, v in zip(truth.range_m, truth.velocity_ms)]
    _line("frame", launches=launches, num_raw=int(res.num_raw_detections),
          num_final=int(res.num_final), found=found,
          targets=np.round(rows, 3).tolist())
    _require(launches["K1"] >= 1 and launches["K2"] >= 1,
             "frame launched K1 and K2")
    _require(bool(np.all(np.isfinite(rows))) and all(found),
             "truth targets found")

    # small widths: the kernel path on the card vs the plain path on the CPU
    small = small_test_config().replace(**PERF_OVERRIDES)
    tb2 = TargetBatch.make([3000.0, 6000.0], [15.0, -8.0], [10.0, 12.0],
                           [20.0, 14.0])
    a = make_frame_processor(small, device=dev)(5, tb2)
    b = make_frame_processor(small, device="cpu")(5, tb2)
    def rows_of(r):
        ok = r.targets.valid.cpu().numpy()
        x = np.stack([r.targets.range_m.cpu().numpy()[ok],
                      r.targets.velocity_ms.cpu().numpy()[ok]], 1)
        return x[np.lexsort((x[:, 1], x[:, 0]))]
    _line("small", card_final=int(a.num_final), cpu_final=int(b.num_final))
    _require(int(a.num_final) == int(b.num_final) >= 2,
             "card and CPU frames agree")
    np.testing.assert_allclose(rows_of(a), rows_of(b), rtol=1e-4)

    # ---- 6. times (CUDA events, median), card and power limit beside
    k1_ms, k1_plain_ms = _time_pair(
        lambda: nr.noise_rdm(plan, lmat, factors, seed=seed, layout="bvg"),
        lambda: nr.noise_rdm_plain(
            plan, lmat, nr.philox_planes(plan, seed, num_b, device=dev),
            factors))
    k2_ms, k2_plain_ms = _time_pair(
        lambda: ck.goca_cfar_qvg(maps_p, cfg.cfar, num_g, num_v),
        lambda: ck.goca_cfar_qvg_plain(maps_p, cfg.cfar, num_g, num_v))
    frame_ms = statistics.median(_event_ms(lambda: process(20261016, truth),
                                           10))
    for name, ms in (("K1", k1_ms), ("K1 plain", k1_plain_ms),
                     ("K2", k2_ms), ("K2 plain", k2_plain_ms),
                     ("frame", frame_ms)):
        _line("time", what=repr(name), ms=round(ms, 4), card=repr(card))

    print(json.dumps({"kernels": [
        {"name": "K1 fused noise RDM (draw mode, rank-K signal)",
         "route": "cuda", "source": "radar_tpu_torch/csrc/noise_rdm.cu",
         "replaces": "radar_tpu/ops/pallas_rdm.py:980",
         "launches": launches["K1"], "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms},
        {"name": "K2 2D GOCA-CFAR on qvg maps", "route": "cuda",
         "source": "radar_tpu_torch/csrc/cfar.cu",
         "replaces": "radar_tpu/ops/pallas_kernels.py:234",
         "launches": launches["K2"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
