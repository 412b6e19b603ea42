"""Smoke run of the PyTorch/CUDA port (radar_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from ``radar_tpu_torch/csrc`` with nvcc (one
process per source, all at once) and checks each against its plain
PyTorch version at the full shapes of the reference's frame (16 channels x
332 pulses x 5819 samples -> RDM [13 beams, 332 Doppler, 3404 gates] -> 12
pair maps). Then it drives the port's paths on the benchmark's two
targets:

- the perf-config frame, through kernels K1 (noise RDM: K1c's planes, the
  3xTF32 strip-GEMM PC, the beam mix and the 3xTF32 DFT GEMM on the tensor
  cores) and K2 (CFAR, TMA-staged, its window compiled in), with the
  profiler's kernel names to show it (the GEMMs and K2 run, the old
  CUDA-core ``pc_kernel`` does not);
- the exact reference stream, the default entry point (per-element echoes
  -> AWGN -> DBF -> PC -> MTD -> vgq tail), through K5 (AWGN, with
  ``noise_impl="pallas"``) and K3 (pair sum + CFAR: a block walks every
  beam of its tile through a ring of TMA-staged beam slots), in five
  configurations, at small widths against the CPU, and in the multi-frame
  driver ``run_multiframe``; K3 is also held bit for bit at full size at
  each compiled-in window and through its generic instantiation, with each
  method, and the profiler shows ``k3_kernel`` in the reference frame;
- the checks of ``scripts/validate_rdm_gen.py``: K1 fed the planes that
  kernel K1c exports (one launch for every segment) equals K1 draw mode
  bit for bit, kernel K4 (the window schedule: K1's GEMMs with the PC's
  noise drawn in its blocks) against K1, and the moments of K1's draws
  against the "pallas" route's torch-drawn planes; K1c and K4 against
  their plain versions (K4 at 13, 1 and 2 beams a block, bit for bit
  alike and equal to K4 planes mode on K1c's planes), and K1c's integer
  issue bound from the SASS of its loop (``cuobjdump``);
- phase ``tails``: one full-width frame of each tail variant (the
  kernel-maps tail, with and without bf16 output and with matmul means,
  bf16 output alone, the beams-major tail on both kernel routes, the perf
  frame with matmul means; on the reference stream tail_from_rdm, the
  native scan, the monopulse flags with pair mode, matmul means), both
  truth targets found in each and each path's kernels counted; the
  kernel-maps frame's detections bit for bit against the plain tail on
  K1's own maps, its mask against the default frame's; K1's maps epilogue
  (``add_maps_kernel``) at f32 and bf16 output bit for bit against its
  plain version on the kernel's own map; the frames' device time, K1 with
  and without the maps, and the epilogue beside ``add_kernel`` and its
  bytes bound;
- the rank-K stream's three noise-RDM routes (``pallas_prng``, ``pallas``
  with normal and uniform rails, ``xla``) at full size and, at small
  widths, against the CPU;
- the Monte-Carlo studies: ``snr_sweep`` of the perf config (5 points x 16
  trials) and one point each of the reference stream and the xla route,
  and ``run_streaming_mc`` (128 injected targets, then the statistical
  hold at 40 targets per scene);
- the noise-RDM kernel studies: phase ``rdm_variants`` runs the planes
  kernel's schedules K10 (resident), K7 (stacked) and K9 (all beams)
  through ``noise_rdm_compact`` with bf16 operands on a cube holding K1c's
  planes (their PC the strip GEMM of ``csrc/band_pc_sm90.cu``, their DFT
  the wgmma GEMM of ``csrc/rdm_sm90.cu``, each counted), then at f32 with
  K7's draw mode (K1's 3xTF32 PC, K4's in draw mode, and DFT GEMM of
  ``csrc/noise_rdm_sm90.cu``, each counted); holds each at f32 and bf16
  against its plain version, K1 and its own f32 map (the f32 three bit
  for bit alike), K10 with bf16 output at both multiply types and K7 on
  its own draws (bit for bit at f32), and K7's bf16 draw mode (the strip
  GEMM whose producer warpgroups draw its stages, counted) bit for bit
  against its bf16 planes mode on K1c's planes, bounded by the larger of
  its bf16 operations and the draws the function needs (each sample once
  at K1c's SASS cost), its own draws' issue time (the producers' loop
  SASS) printed as a diagnostic; times each at both types on a busy and
  an idle card with the host's ms a call and the profiler's split (each
  kernel's mean over the launches the profiler recorded, times its
  launches a call; PC, join, DFT, mix, the wrapper's casts and pads; at
  f32 none of the retired CUDA-core kernels may show), beside both bounds
  at f32, and the
  DFT GEMM alone beside its plain version and one bf16 ``torch.matmul``;
  phase ``pc_study`` runs ``scripts/bench_pc2d.py``'s three
  chains (cuBLAS banded, flat 2D, K8) and holds K8 against its plain
  version and the banded-matmul PC, then splits K8 at bf16 into its
  staging kernel and strip GEMM (profiler) with the GEMM's TFLOP/s over
  the band it walks and over the convolution's own MACs, and runs K8 at
  f32 (f32 staging, then K1's 3xTF32 strip GEMM with both passes in one
  launch, counted), split and timed beside both its bounds and three f32
  ``torch.matmul`` calls;
- phase ``tracking``: the device-scan multi-frame runner
  (``run_multiframe_device``) on the five-target headline (perf config,
  simple kinematics, 50 frames x 3 seeds, K1 and K2 counted at 50 a run:
  5 clean tracks a seed, at most one false track in all), a 12-frame run
  stopped after 8 and resumed from its store (bit for bit the run without
  chunks), the two-target altitude scene against the host loop, 10 frames
  of the exact stream (K3 at 10), the tracking Monte-Carlo's entry point
  (6 scenes x 40 frames: mean track Pd >= 0.95, no switched track) and
  the smoother on the headline's tracks; each run's frames/s, event ms
  and host syncs a frame, one run's idle share by the profiler, the
  native associator's host ms;
- phase ``realdata``: the second detector family at the reference's
  gated size (332 pulses x 3404 gates x 16 channels): a ``.bin`` frame
  pair with an injected target written by the native writer and read
  onto the card by the native reader (and the numpy reader, bit for bit
  alike), ``run_realdata_pipeline`` and ``run_realdata_pipeline_windowed``
  (the target within 3 gates and 2 Doppler bins in the frame and every
  slice, the RDM within 1e-5 of the port's CPU run, no kernel counted),
  timed by events with host syncs, idle share and a stage split; phase
  ``doa``: MUSIC 1D/2D (refined), root-MUSIC and both ESPRITs at 128
  elements within ``tests/test_doa.py``'s tolerances, each one's host ms;
  phase ``scripts``: ``run_roc_realdata`` at its defaults and
  ``run_doa_accuracy`` at 10 trials on the card;
- the multi-device layer (phase ``multichip``, the arms of
  ``__graft_entry__.py::dryrun_multichip``): 4 ranks through
  ``run_ranks``, all on one card (gloo, plain collectives staged through
  the host) or one per card on NCCL with 4 cards. ``range_rdma`` runs the
  range-sharded PC of a full frame's beams (4316 rows x 5819 samples,
  700-tap matched filter) with kernel K6's peer-store halo ring, whose
  push and fill kernels build each rank's overlap-save FFT input in place,
  and holds the halo, the FFT input and the output bit for bit against
  the plain ring (then times the push, the fill, a whole exchange and the
  FFT input built through the [rows, halo] contract, cat and pad, one rank
  at a time, beside copy_); ``perf_dp_fused``/``perf_dp_xla``
  run 4 perf frames at dp=4, ``stream``/``lowrank`` one frame sharded over
  (ch=2, cpi=2), ``dp_x_model`` 4 frames at dp=2 x ch=2, ``mc_dp`` the
  perf sweep and a streaming MC at dp=4, ``doa_cov`` ``music_2d(mesh=)``
  with the 512 snapshots of a 128-element URA sharded over the ranks,
  each against its single-rank run.

K1, K2 and K4 are also timed on a card kept busy (events behind a sleep
kernel) beside the idle card and the host's time a call; K1 and K4 are
split by the profiler (K1c's planes, the PC GEMM's main and correction
passes, the mix, the DFT GEMM's, the add of its passes and the signal),
beside both their bounds (f32 on the CUDA cores, 3xTF32 on the tensor
cores) and, for K1, the xla route's cuBLAS chain in f32 (the old CUDA-core
K1 and K4 are timed beside them by ``scripts/ablate_k1.py`` and
``scripts/ablate_k4_k9.py``).

The launch counters are set to 0 just before each path runs and read just
after, to show the path went through its kernels. Kernels, plain versions,
library calls and frames are timed with CUDA events, Monte-Carlo
throughput with the host clock. Every phase prints one line; any failure
raises and exits non-zero. The line before the last lists every kernel
with its bound; the last line is the result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The SASS of the compiled libraries (``cuobjdump``) shows ``HGMMA`` in
the DFT GEMM, K4's and K8's PC and both strip GEMMs, and ``UTMALDG`` in
K3.
Without CUDA, or without the repository beside it, it fails at once.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

PEAK_FP32 = 67e12     # H100 SXM FLOP/s, float32 outside the tensor cores
PEAK_BF16 = 989e12    # H100 SXM FLOP/s, bf16 tensor cores, dense
PEAK_TF32 = 495e12    # H100 SXM FLOP/s, TF32 tensor cores, dense
PEAK_HBM = 3.35e12    # H100 SXM HBM bytes/s
PEAK_NVLINK = 450e9   # H100 SXM NVLink bytes/s each way, card to card


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


def _one_event_ms(fn, busy: bool = True) -> tuple:
    """(CUDA-event ms, host ms) of one call of ``fn``; ``busy`` puts a
    sleep kernel ahead of the first event, so that the card is still busy
    while the host launches ``fn`` and the events hold device time only,
    not the host's work before the first launch."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if busy:
        torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    t0 = time.perf_counter()
    fn()
    host = (time.perf_counter() - t0) * 1e3
    b.record()
    b.synchronize()
    return a.elapsed_time(b), host


def _busy_event_ms(fn, reps: int = 10):
    """(median CUDA-event ms, median host ms) of ``fn`` on a card kept
    busy (``_one_event_ms``)."""
    busy, host = zip(*(_one_event_ms(fn) for _ in range(reps)))
    return statistics.median(busy), statistics.median(host)


def _found(rows, truth, dr: float, dv: float) -> list:
    """Whether each truth target has a row within 2 gates and 2 Doppler
    bins."""
    return [bool(np.any((np.abs(rows[:, 0] - r) <= 2 * dr)
                        & (np.abs(rows[:, 1] - v) <= 2 * dv)))
            for r, v in zip(truth.range_m, truth.velocity_ms)]


def _rows(res):
    """Valid final targets of a FrameResult as host rows (range, velocity,
    angle, power)."""
    t = res.targets
    ok = t.valid.cpu().numpy()
    return np.stack([x.cpu().numpy()[ok] for x in
                     (t.range_m, t.velocity_ms, t.angle_deg, t.power)], 1)


def _same_rows(a, b, rtol: float) -> None:
    """Rows of ``a`` paired with the nearest row of ``b`` in (range,
    velocity), then held to ``rtol``."""
    _require(a.shape == b.shape, f"same targets {a.shape} vs {b.shape}")
    dist = (np.abs(a[:, None, 0] - b[None, :, 0])
            + 10 * np.abs(a[:, None, 1] - b[None, :, 1]))
    pair = np.argmin(dist, axis=1)
    _require(len(set(pair.tolist())) == len(pair), "targets pair up")
    np.testing.assert_allclose(a, b[pair], rtol=rtol)


def _reference_stages(cfg, pre, truth, dev, reps: int = 5) -> dict:
    """Median CUDA-event ms of each stage of the reference stream with K5
    noise (the frame processor's composition, stage by stage)."""
    import torch

    from radar_tpu_torch.cluster.stages import cluster_stage1, cluster_stage2
    from radar_tpu_torch.measure.estimate import estimate_parameters
    from radar_tpu_torch.ops.awgn import awgn
    from radar_tpu_torch.ops.cfar import extract_detections
    from radar_tpu_torch.ops.cfar_kernel import goca_cfar_2d_fused
    from radar_tpu_torch.ops.dbf import dbf
    from radar_tpu_torch.ops.mtd import make_mtd_matrix, mtd_matmul
    from radar_tpu_torch.ops.noise_rdm import seed_words
    from radar_tpu_torch.ops.pulse_compression import (
        make_matmul_plan, pulse_compress_matmul, to_device)
    from radar_tpu_torch.pipeline.frame import measure_consts
    from radar_tpu_torch.sim.echo import synthesize_echoes

    mplan = to_device(make_matmul_plan(pre), dev)
    mtd_t = torch.as_tensor(make_mtd_matrix(pre.mtd_win, cfg.sig.prt_num)
                            ).to(dev, torch.complex64)
    mc = measure_consts(cfg, pre, device=dev)
    ip, st = cfg.interp, {}

    def maps():
        mag = st["mag"]
        st["maps"] = (mag[:-1] + mag[1:]).permute(1, 2, 0)

    stages = (
        ("synthesis", lambda: st.update(
            raw=synthesize_echoes(truth, pre, cfg, device=dev))),
        ("K5 AWGN", lambda: st.update(noisy=awgn(st["raw"],
                                                  seed_words(3)))),
        ("DBF", lambda: st.update(beams=dbf(st["noisy"], pre.dbf_w))),
        ("PC (banded matmul)", lambda: st.update(
            pc=pulse_compress_matmul(st["beams"], mplan))),
        ("MTD (matmul)", lambda: st.update(rdm=mtd_matmul(st["pc"], mtd_t))),
        ("|RDM| beams-major", lambda: st.update(
            mag=st["rdm"].permute(2, 0, 1).abs().contiguous())),
        ("K3 CFAR", lambda: st.update(
            mask=goca_cfar_2d_fused(st["mag"], cfg.cfar)[0])),
        ("pair maps", maps),
        ("extraction", lambda: st.update(dets=extract_detections(
            st["mask"], st["maps"], cfg.cfar.max_detections,
            layout="vgq"))),
        ("estimation", lambda: st.update(params=estimate_parameters(
            st["dets"], st["maps"], st["rdm"], mc, ip.extra_dots,
            ip.r_interp_times, ip.v_interp_times, maps_layout="vgq"))),
        ("clustering", lambda: cluster_stage2(cluster_stage1(
            st["params"], cfg.cluster), cfg.cluster)),
    )
    times = {name: [] for name, _ in stages}
    for _ in range(reps + 1):
        for name, fn in stages:
            times[name] += _event_ms(fn, 1)
    return {name: statistics.median(t[1:]) for name, t in times.items()}


def _kernel_profile(fn, reps: int = 5) -> dict:
    """{kernel name: (device ms per call, launches a call the profiler
    recorded)} of ``fn`` from torch.profiler. A kernel's ms a call is its
    mean over the launches recorded times its launches a call (the
    recorded ones over ``reps``, rounded): in this script's process the
    profiler has missed the first launches of a window (K4's PC, mix and
    DFT recorded 4 calls of 5; the drawing strip GEMM 2 of 3), and the sum
    over ``reps`` then read low."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    # kernel rows only: an operator's row repeats its kernels' device time
    dev_t = lambda e: getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0))
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and dev_t(e) > 0:
            seen = e.count / reps
            calls = round(seen) if seen >= 0.5 else seen
            out[e.key] = (dev_t(e) / e.count / 1000.0 * calls, seen)
    return out


def _kernel_ms(fn, reps: int = 5) -> dict:
    """Device ms per call of ``fn`` by kernel name (``_kernel_profile``)."""
    return {k: ms for k, (ms, _) in _kernel_profile(fn, reps).items()}


def _busy_top(ms: dict):
    """(device-busy ms, the six longest kernels) of ``_kernel_ms``'s
    result."""
    top = sorted(ms.items(), key=lambda kv: kv[1], reverse=True)[:6]
    return sum(ms.values()), [(k[:60], round(v, 4)) for k, v in top]


def _device_busy_ms(fn, reps: int = 5):
    """(device-busy ms per call, top kernels) from torch.profiler."""
    return _busy_top(_kernel_ms(fn, reps))


def _named_ms(ms: dict, name: str) -> float:
    """The summed ms of the kernels of ``ms`` whose name holds ``name``."""
    return sum(v for k, v in ms.items() if name in k)


def _k1_bound_ms(plan, num_b: int, peak: float = PEAK_FP32,
                 products: int = 1) -> float:
    """Least time of the noise RDM's work (K1, K4, K7, K9, K10) at the
    ``peak`` of its operand type: the complex MACs of the convolutions, the
    beam mix and the DFT, 8 FLOPs each, ``products`` times (3 for K1's
    3xTF32; the rank-K signal epilogue is negligible)."""
    conv = sum(s.j_len * s.taps.shape[0] for s in plan.segments)
    macs = num_b * plan.n_pulses * (conv + num_b * plan.n_gates
                                    + plan.n_dop * plan.n_gates)
    return 8.0 * products * macs / peak * 1e3


def _bound(ops_ms: float, bytes_ms: float):
    """(bound ms, what bounds it): the larger of the two least times."""
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def _rel_rms(a, b) -> float:
    """RMS of a - b over the RMS of b."""
    return float((a - b).abs().pow(2).mean().sqrt()
                 / b.abs().pow(2).mean().sqrt())


def _bytes_ms(*tensors) -> float:
    """Least time to move each tensor once at the HBM rate."""
    return sum(t.numel() * t.element_size() for t in tensors) / PEAK_HBM * 1e3


# Hopper's integer pipes, each 64 lanes an SM and clock: the IMAD family
# (IMAD, IMAD.WIDE, IMAD.HI, IMAD.MOV, IMAD.X) on the FMA-heavy pipe, the
# other integer instructions on the ALU pipe; the four schedulers of an SM
# issue 128 lanes' instructions a clock in all.
IMAD_OPS = ("IMAD",)
ALU_OPS = ("IADD3", "VIADD", "LOP3", "SHF", "LEA", "ISETP", "SEL", "PRMT",
           "MOV", "IMNMX", "IABS", "BMSK", "SGXT")
PEAK_PIPE_PER_SM = 64
PEAK_ISSUE_PER_SM = 128


def _loop_sass(lib_path: str, kernel: str, store: str = "STG",
               per_store: int = 2, innermost: bool = False) -> dict:
    """The SASS of the longest loop of ``kernel`` in the compiled library
    (``cuobjdump -sass``; with ``innermost``, the shortest loop holding the
    16-byte ``store``s): its instruction counts by opcode, the samples one
    pass stores (``per_store`` samples a 16-byte ``store``: 2 for f32 re
    and im planes, 4 for bf16), and per sample its FMA-heavy-pipe
    instructions (``IMAD_OPS``; IMAD.WIDE counted once, and twice in
    ``imad_wide2_per_sample``), its ALU-pipe ones (``ALU_OPS``) and all its
    instructions; ``clocks_per_sample`` is the SM clocks a sample takes at
    the busiest of these rates (pipes at ``PEAK_PIPE_PER_SM``, issue at
    ``PEAK_ISSUE_PER_SM``), and ``clocks_per_sample_wide2`` the same with
    IMAD.WIDE at two slots."""
    import re

    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    funcs = [f for f in sass.split("Function : ")[1:]
             if kernel in f.split("\n", 1)[0]]
    _require(len(funcs) == 1, f"one SASS function named {kernel}")
    ins = [(int(a, 16), op, line) for a, op, line in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+((?:@!?U?P\w+\s+)?[A-Z][A-Z0-9_.]+)([^;]*)",
        funcs[0])]
    loops = [(int(m.group(1), 16), a) for a, op, line in ins
             if op.split()[-1] == "BRA" and
             (m := re.search(r"0x([0-9a-f]+)", line)) and
             int(m.group(1), 16) < a]
    _require(len(loops) >= 1, f"a loop in {kernel}")
    stores_in = lambda lo, hi: sum(
        1 for a, op, _ in ins if lo <= a <= hi
        and op.split()[-1].startswith(store) and ".128" in op)
    if innermost:
        loops = [ab for ab in loops if stores_in(*ab) >= 2]
        _require(len(loops) >= 1, f"a loop of {kernel} storing {store}")
        lo, hi = min(loops, key=lambda ab: ab[1] - ab[0])
    else:
        lo, hi = max(loops, key=lambda ab: ab[1] - ab[0])
    body = [op.split()[-1] for a, op, _ in ins if lo <= a <= hi]
    hist = {}
    for op in body:
        hist[op] = hist.get(op, 0) + 1
    count = lambda ops: sum(n for op, n in hist.items()
                            if op.split(".")[0] in ops)
    stores = stores_in(lo, hi)
    _require(stores >= 2 and stores % 2 == 0,
             f"{kernel}'s loop stores 16-byte vectors to both planes")
    samples = per_store * stores
    wide = sum(n for op, n in hist.items() if op.startswith("IMAD.WIDE"))
    imad, alu = count(IMAD_OPS) / samples, count(ALU_OPS) / samples
    every = sum(hist.values()) / samples
    clocks = lambda fma: max(fma / PEAK_PIPE_PER_SM, alu / PEAK_PIPE_PER_SM,
                             every / PEAK_ISSUE_PER_SM)
    return {"ops": hist, "samples": samples, "imad_per_sample": imad,
            "imad_wide2_per_sample": imad + wide / samples,
            "alu_per_sample": alu, "all_per_sample": every,
            "clocks_per_sample": clocks(imad),
            "clocks_per_sample_wide2": clocks(imad + wide / samples)}


def _sass_has(lib_path: str, kernel: str, opcode: str) -> list:
    """For each function of the compiled library whose name holds
    ``kernel`` (``cuobjdump -sass``), whether its SASS holds ``opcode``."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    return [opcode in f for f in sass.split("Function : ")[1:]
            if kernel in f.split("\n", 1)[0]]


def _validate_rdm_gen(nr, lr_prng, lr_uni, lr_norm, plan, lmat, dev, counts,
                      reset) -> dict:
    """The checks of scripts/validate_rdm_gen.py through the port's entry
    points: K1 on K1c's planes == K1 draw mode (bit check), K4 (all beams
    per block) vs K1 (rolling check), and the moments of K1 draw mode vs
    the "pallas" route's torch-drawn planes over eight frames. The launch
    counters are read around these checks only. Returns (results, K1c's
    planes, the Philox key)."""
    import torch

    from radar_tpu_torch.pipeline.driver import frame_seed

    num_b = lmat.shape[0]
    seed = nr.seed_words(frame_seed(12345, 1))
    reset()
    planes = nr.gen_noise_planes(plan, seed, num_b, device=dev)
    y_gen = nr.noise_rdm(plan, lmat, seed=seed, layout="bvg")
    y_dma = nr.noise_rdm(plan, lmat, planes=planes, layout="bvg")
    y_k4 = nr.noise_rdm(plan, lmat, seed=seed, layout="bvg", rolling=False,
                        beams_per_step=num_b)

    def moments(noise_rdm):
        acc = torch.zeros(3, dtype=torch.float64, device=dev)
        for i in range(8):
            y = noise_rdm(frame_seed(7, i), layout="bvg")
            yr = torch.view_as_real(y).double()
            var = (yr ** 2).mean()
            acc += torch.stack([yr.mean(), var,
                                (y.abs() > 8.0 * var.sqrt()).sum().double()])
        m = (acc / 8).tolist()
        return {"mean": m[0], "var": m[1], "tail_count_8sigma": m[2]}

    out = {"moments_pallas_prng": moments(lr_prng.noise_rdm),
           "moments_pallas_uniform": moments(lr_uni.noise_rdm),
           "moments_pallas_normal": moments(lr_norm.noise_rdm)}
    torch.cuda.synchronize()
    out["launches"] = counts()
    bit = float((y_gen - y_dma).abs().max())
    ymax = float(y_gen.abs().max())
    roll = float((y_k4 - y_gen).abs().max())
    out["bit_check"] = {"max_abs_diff": bit, "max_abs_out": ymax,
                        "pass": bit == 0.0 and ymax > 0.0}
    out["rolling_check"] = {"max_abs_diff": roll, "max_abs_out": ymax,
                            "rel": roll / ymax,
                            "pass": ymax > 0.0 and roll <= 2.0 ** -7 * ymax}
    base = out["moments_pallas_uniform"]["var"]
    out["var_ratio"] = out["moments_pallas_prng"]["var"] / base
    out["var_ratio_normal"] = out["moments_pallas_normal"]["var"] / base
    out["moments_pass"] = (abs(out["var_ratio"] - 1.0) < 0.02 and
                           abs(out["moments_pallas_prng"]["mean"]) < 1e-2)
    return out, planes, seed


# bf16 holds at full size, RMS of the difference over the RMS: both sides
# round the same values at the same points, but their f32 sums (700 taps,
# 332 pulses) are taken in other orders (on the tensor cores, not even
# IEEE-sequential), so a few intermediates land on the other side of a
# bf16 rounding boundary (2^-8 on that element; 1.4e-4 measured for the
# CUDA-core K10). A missing or misplaced rounding point costs >= 1e-3
# (bf16 vs f32 is ~4e-3), so 3e-4 still catches it. The output rounding of
# bf16 planes turns such a flip into a whole output ulp: twice that.
BF16_HOLD = 3e-4
BF16_OUT_HOLD = 6e-4
VARIANTS = (("K10", "resident", "radar_tpu/ops/pallas_rdm.py:789"),
            ("K7", "stacked", "radar_tpu/ops/pallas_rdm.py:627"),
            ("K9", "allbeams", "radar_tpu/ops/pallas_rdm.py:1088"))


def _rdm_variants(nr, plan, lmat, dev, card) -> dict:
    """Phase ``rdm_variants``: the planes kernel's schedules K10, K7 and K9
    through the A/B entry point ``noise_rdm_compact`` at full size, on a
    compact cube holding K1c's planes for one seed, then each schedule at
    f32 and bf16 against its plain version, K1 and its own f32 map; K7 on
    its own draws; times. Returns the kernels-line rows."""
    import torch

    bf, f32 = torch.bfloat16, torch.float32
    num_b, num_p = lmat.shape[0], plan.n_pulses
    seed = nr.seed_words(4242)
    planes = nr.gen_noise_planes(plan, seed, num_b, device=dev)
    planes16 = [(x.to(bf), y.to(bf)) for x, y in planes]
    z = torch.zeros((num_b, num_p, plan.s_compact), dtype=torch.complex64,
                    device=dev)
    for seg, (xr, xi) in zip(plan.segments, planes):
        sl = slice(seg.pad_front, seg.pad_front + seg.r_len)
        z[:, :, seg.c0:seg.c0 + seg.r_len] = torch.complex(xr[..., sl],
                                                           xi[..., sl])
    torch.cuda.synchronize()
    counts = lambda: {k: getattr(nr, f"{k.lower()}_launch_count")
                      for k, _, _ in VARIANTS}
    for k, _, _ in VARIANTS:
        setattr(nr, f"{k.lower()}_launch_count", 0)
    nr.strip_pc_launch_count = 0
    nr.dft_launch_count = 0
    y16 = {v: nr.noise_rdm_compact(z, plan, lmat, variant=v, mul_dtype=bf)
           for _, v, _ in VARIANTS}
    torch.cuda.synchronize()
    launches = counts()
    parts = {"strip_gemm": nr.strip_pc_launch_count,
             "dft_gemm": nr.dft_launch_count}
    _line("rdm_variants", path="noise_rdm_compact(variant=, mul_dtype=bf16)",
          launches=launches, part_launches=parts)
    _require(all(n >= 1 for n in launches.values()),
             "the schedules' path launched K10, K7 and K9")
    _require(parts == {"strip_gemm": 3, "dft_gemm": 3},
             "K10's, K7's and K9's bf16 PC ran the strip GEMM, their DFT "
             "the wgmma GEMM")
    # the f32 path: each schedule once through noise_rdm_compact, and K7's
    # draw mode, on K1's 3xTF32 GEMMs (the planes' PC k1_tf32_pc, the draw
    # mode's k4_tf32_pc, every DFT k1_tf32_dft)
    for k, _, _ in VARIANTS:
        setattr(nr, f"{k.lower()}_launch_count", 0)
    nr.tf32_pc_launch_count = nr.k4_pc_launch_count = 0
    nr.tf32_dft_launch_count = 0
    for _, v, _ in VARIANTS:
        nr.noise_rdm_compact(z, plan, lmat, variant=v)
    nr.noise_rdm(plan, lmat, seed=seed, stacked=True, layout="bvg")
    torch.cuda.synchronize()
    launches32 = counts()
    parts32 = {"tf32_pc": nr.tf32_pc_launch_count,
               "tf32_pc_drawn": nr.k4_pc_launch_count,
               "tf32_dft": nr.tf32_dft_launch_count}
    _line("rdm_variants", path="noise_rdm_compact(variant=) and "
          "noise_rdm(seed=, stacked=True), f32", launches=launches32,
          part_launches=parts32)
    _require(launches32 == {"K10": 1, "K7": 2, "K9": 1}
             and parts32 == {"tf32_pc": 3, "tf32_pc_drawn": 1,
                             "tf32_dft": 4},
             "each f32 schedule call ran K1's 3xTF32 PC (K4's in draw "
             "mode) and DFT GEMM once")

    ref = {md: nr.noise_rdm_plain(plan, lmat, planes, mul_dtype=md)
           for md in (f32, bf)}
    k1 = nr.noise_rdm(plan, lmat, planes=planes, layout="bvg")
    errs, first = {}, None
    for name, v, _ in VARIANTS:
        y32 = nr.noise_rdm(plan, lmat, planes=planes, variant=v,
                           layout="bvg")
        y = nr.noise_rdm(plan, lmat, planes=planes16, variant=v,
                         mul_dtype=bf, layout="bvg")
        torch.cuda.synchronize()
        first = first or (y32, y)
        e = {"identical_to_K10": [bool(torch.equal(y32, first[0])),
                                  bool(torch.equal(y, first[1]))],
             "f32_vs_plain": _rel_rms(y32, ref[f32]),
             "bf16_vs_plain": _rel_rms(y, ref[bf]),
             "f32_vs_K1": _rel_rms(y32, k1),
             "f32_max_abs_err": float((y32 - ref[f32]).abs().max()),
             "bf16_vs_own_f32": _rel_rms(y, y32),
             "compact_equals_planes": bool(torch.equal(
                 y16[v].permute(2, 0, 1), y)),
             "bf16_max_abs_err": float((y - ref[bf]).abs().max())}
        errs[name] = e
        _line("rdm_variants", kernel=name, variant=v, **e,
              tol=f"f32 <=1e-5, bf16 <={BF16_HOLD} (rms rel); vs K1 "
                  "<=1e-5; bf16 vs f32 in [1e-3, 1e-2]; f32 identical "
                  "to K10's")
        # at f32 the three schedules sum in the same order: bit for bit
        _require(e["identical_to_K10"][0]
                 and e["f32_vs_plain"] <= 1e-5
                 and e["bf16_vs_plain"] <= BF16_HOLD
                 and e["f32_vs_K1"] <= 1e-5
                 and 1e-3 <= e["bf16_vs_own_f32"] <= 1e-2
                 and e["compact_equals_planes"]
                 and bool(torch.isfinite(torch.view_as_real(y)).all()),
                 f"{name} ({v}) holds")
        del y32, y
    out16 = nr.noise_rdm(plan, lmat, planes=planes16, variant="resident",
                         mul_dtype=bf, out_dtype=bf, layout="bvg")
    # f32 multiplies, bf16 output: the mix-after epilogue rounds last, so
    # the map is the f32-output map rounded, exactly
    out16_32 = nr.noise_rdm(plan, lmat, planes=planes, variant="resident",
                            out_dtype=bf, layout="bvg")
    ref_out16 = nr.noise_rdm_plain(plan, lmat, planes, mul_dtype=bf,
                                   out_dtype=bf)
    drawn = nr.noise_rdm(plan, lmat, seed=seed, stacked=True, layout="bvg")
    fed = nr.noise_rdm(plan, lmat, planes=planes, variant="stacked",
                       layout="bvg")
    torch.cuda.synchronize()
    e_out = _rel_rms(out16, ref_out16)
    e_draw = _rel_rms(drawn, fed)
    out32_rounded = bool(torch.equal(out16_32, nr.round_mul(first[0], bf)))
    _line("rdm_variants", resident_bf16_out_vs_plain=e_out,
          out_rounded=bool(torch.equal(out16, nr.round_mul(out16, bf))),
          f32_mul_bf16_out_is_f32_map_rounded=out32_rounded,
          stacked_draws_vs_planes=e_draw,
          stacked_draws_identical=bool(torch.equal(drawn, fed)),
          tol=f"bf16 out <={BF16_OUT_HOLD}; f32 draws == K7 on K1c's "
              "planes; f32 with bf16 out == the f32 map rounded")
    _require(e_out <= BF16_OUT_HOLD and torch.equal(out16, nr.round_mul(out16, bf)),
             "K10 with bf16 output planes")
    _require(out32_rounded, "K10 f32 with bf16 output == its f32 map rounded")
    _require(bool(torch.equal(drawn, fed)) and e_draw == 0.0,
             "K7 draw mode == K7 on K1c's planes, bit for bit")
    del ref, k1, out16, ref_out16, drawn, fed, y16, first, out16_32

    # times at bf16 (the TPU's default), kernel vs plain on the same cube:
    # idle-card events in turns with the plain version, busy-card events
    # and host ms a call, the profiler's split
    planes_c = nr.planes_from_compact(z, plan, bf)
    rows = []
    n_in = z.numel() * z.element_size()
    n_out = num_b * plan.n_dop * plan.n_gates * 8
    bound, by = _bound(_k1_bound_ms(plan, num_b, PEAK_BF16),
                       (n_in + n_out) / PEAK_HBM * 1e3)
    split_names = (("strip_gemm", "strip_pc_kernel"),
                   ("dft_gemm", "dft_kernel"),
                   ("mix", "::mix_kernel<"))
    for name, v, rep in VARIANTS:
        call = lambda: nr.noise_rdm_compact(z, plan, lmat, variant=v,
                                            mul_dtype=bf)
        ms, pms = _time_pair(
            call, lambda: nr.noise_rdm_plain(plan, lmat, planes_c,
                                             mul_dtype=bf))
        busy_ms, host_ms = _busy_event_ms(call)
        prof = _kernel_ms(call, reps=3)
        busy, top = _busy_top(prof)
        split = {k: _named_ms(prof, key) for k, key in split_names}
        split = {k: ms_ for k, ms_ in split.items() if ms_ > 0.0}
        # the rest: the wrapper's casts and pads (planes_from_compact)
        split["wrapper"] = busy - sum(split.values())
        _line("time", what=repr(f"{name} ({v}, bf16) / plain"),
              busy_card_ms=round(busy_ms, 4), idle_card_ms=round(ms, 4),
              host_ms=round(host_ms, 4), plain_ms=round(pms, 4),
              device_busy_ms=round(busy, 4),
              profile_ms={k: round(x, 4) for k, x in split.items()},
              top_kernels=top, card=repr(card))
        rows.append((f"{name} noise RDM, variant={v!r}, bf16 operands",
                     "rdm_sm90.cu",
                     rep, launches[name], errs[name]["bf16_max_abs_err"],
                     busy_ms, pms, bound, by, None,
                     {"ms_is": "events around one call, the card kept busy",
                      "idle_card_ms": ms, "host_ms": host_ms,
                      "profile_ms": split}))
    drawn32 = parts32["tf32_pc_drawn"]
    rows += _f32_schedules(nr, plan, lmat, z, seed, errs, {
        **launches32, "K7": launches32["K7"] - drawn32,
        "K7 draw mode": drawn32}, card)
    rows.append(_k7_draw_bf16(nr, plan, lmat, planes, seed, n_out, card))
    rows.append(_dft_gemm(nr, plan, planes_c, parts["dft_gemm"], card))
    k1p_ms, k1p_plain_ms = _time_pair(
        lambda: nr.noise_rdm(plan, lmat, planes=planes, layout="bvg"),
        lambda: nr.noise_rdm_plain(plan, lmat, planes))
    _line("time", what=repr("K1 planes mode / plain"), ms=round(k1p_ms, 4),
          plain_ms=round(k1p_plain_ms, 4), card=repr(card))
    return rows


def _k7_draw_bf16(nr, plan, lmat, planes, seed, n_out: int, card) -> tuple:
    """K7 in draw mode at bf16 (stacked=True: the strip GEMM whose two
    producer warpgroups draw its data's stages, then the wgmma DFT GEMM and
    the mix): one strip-GEMM launch in draw mode, equal bit for bit to K7's
    bf16 planes mode on K1c's ``planes``, vs its plain version on the same
    draws; busy/idle/host, the profiler's split with the launches it
    recorded, and its bound: the larger of the bf16 operations, the bytes,
    and the draws the function needs (each sample once, as K1c and the
    TPU's rolling kernel draw it, at K1c's SASS cost a sample). The
    design's own draws (each sample once for every 128-gate block whose
    window holds it, at the producers' loop SASS cost) are printed beside
    it as a diagnostic, not as a bound. Returns its kernels-line row."""
    import torch

    from radar_tpu_torch import _build

    bf = torch.bfloat16
    num_b = lmat.shape[0]
    draw = lambda: nr.noise_rdm(plan, lmat, seed=seed, stacked=True,
                                mul_dtype=bf, layout="bvg")
    ref_draw = nr.noise_rdm_plain(plan, lmat, planes, mul_dtype=bf)
    fed = nr.noise_rdm(plan, lmat, planes=planes, variant="stacked",
                       mul_dtype=bf, layout="bvg")
    nr.k7_launch_count = nr.strip_pc_draw_launch_count = 0
    nr.strip_pc_launch_count = 0
    y_draw = draw()
    torch.cuda.synchronize()
    launches = {"K7": nr.k7_launch_count,
                "strip_gemm_drawn": nr.strip_pc_draw_launch_count,
                "strip_gemm_planes": nr.strip_pc_launch_count}
    e_draw16 = _rel_rms(y_draw, ref_draw)
    err_draw16 = float((y_draw - ref_draw).abs().max())
    same = bool(torch.equal(y_draw, fed))
    _line("rdm_variants", path="noise_rdm(seed=, stacked=True, "
          "mul_dtype=bf16)", launches=launches, rms_err_over_rms=e_draw16,
          equals_bf16_planes_mode_on_K1c_planes=same,
          tol=f"<={BF16_HOLD} (rms rel); == planes mode bit for bit")
    _require(launches == {"K7": 1, "strip_gemm_drawn": 1,
                          "strip_gemm_planes": 0},
             "K7's bf16 draw mode ran the strip GEMM's draw mode once")
    _require(e_draw16 <= BF16_HOLD, "K7 draw mode at bf16 vs plain")
    _require(same, "K7 draw mode at bf16 == K7 bf16 planes mode on K1c's "
             "planes, bit for bit")
    del y_draw, ref_draw, fed
    d_ms, d_pms = _time_pair(draw, lambda: nr.noise_rdm_plain(
        plan, lmat, nr.philox_planes(plan, seed, num_b, device=lmat.device),
        mul_dtype=bf))
    d_busy, d_host = _busy_event_ms(draw)
    d_prof = _kernel_profile(draw, reps=10)
    parts = (("pc_strip_gemm_drawn", "strip_pc_kernel<true>"),
             ("dft_gemm", "dft_kernel"), ("mix", "::mix_kernel<"))
    d_split = {part: sum(v[0] for k, v in d_prof.items() if key in k)
               for part, key in parts}
    d_seen = {part: sum(v[1] for k, v in d_prof.items() if key in k)
              for part, key in parts}
    retired = [k[:60] for k in d_prof if "band_pc_tc_kernel" in k]
    _require(d_split["pc_strip_gemm_drawn"] > 0.0 and not retired,
             "the profiler saw the drawing strip GEMM and no mma.sync PC")
    # the draws the function needs: each sample once, at K1c's SASS cost a
    # sample (its loop's busiest pipe or issue); the design's draws: the
    # producers' loop SASS (4 bf16 samples a 16-byte shared store, re and
    # im) times the samples it draws, each once for every 128-gate block
    # whose window holds it
    k1c_sass = _loop_sass(_build._library_path("noise_rdm")[1],
                          "planes_kernelILb1E")
    sass = _loop_sass(_build._library_path("band_pc_sm90")[1],
                      "strip_pc_kernelILb1E", store="STS", per_store=4,
                      innermost=True)
    rows_ = num_b * plan.n_pulses
    samples = rows_ * sum(sg.r_len for sg in plan.segments)
    drawn = rows_ * sum(-(-sg.j_len // nr.STRIP_BN) * sg.strip.shape[2]
                        for sg in plan.segments)
    _, sm_max_mhz = _sm_clocks()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue_ms = lambda clocks, n: clocks * n / (sms * sm_max_mhz * 1e6) * 1e3
    draws_ms = issue_ms(k1c_sass["clocks_per_sample"], samples)
    design_ms = issue_ms(sass["clocks_per_sample"], drawn)
    ops_ms = _k1_bound_ms(plan, num_b, PEAK_BF16)
    bytes_ms = n_out / PEAK_HBM * 1e3
    d_bound, d_by = _bound(max(ops_ms, draws_ms), bytes_ms)
    _line("time", what=repr("K7 draw mode (stacked=True, bf16) / plain"),
          busy_card_ms=round(d_busy, 4), idle_card_ms=round(d_ms, 4),
          host_ms=round(d_host, 4), plain_ms=round(d_pms, 4),
          rms_err_over_rms=e_draw16, profile_ms=d_split,
          profile_launches_recorded_a_call=d_seen,
          bound_ms=round(d_bound, 4), ops_bound_ms=round(ops_ms, 4),
          draws_bound_ms=round(draws_ms, 4), samples_needed=samples,
          k1c_clocks_per_sample=k1c_sass["clocks_per_sample"],
          bytes_bound_ms=round(bytes_ms, 4),
          design_draws_issue_ms=round(design_ms, 4), design_draws=drawn,
          draw_loop_sass=sass, card=repr(card))
    return ("K7 noise RDM, draw mode (stacked=True), bf16 operands: the "
            "strip GEMM with two drawing producer warpgroups (TMA strip, "
            "wgmma), wgmma DFT, mix", "band_pc_sm90.cu",
            "radar_tpu/ops/pallas_rdm.py:980 (rolling=True, stacked=True)",
            launches["K7"], err_draw16, d_busy, d_pms, d_bound, d_by, None,
            {"ms_is": "events around one call, the card kept busy",
             "idle_card_ms": d_ms, "host_ms": d_host, "profile_ms": d_split,
             "ops_bound_ms": ops_ms, "draws_bound_ms": draws_ms,
             "draws_bound_note": "the samples the function needs, each "
                                 "once, at K1c's SASS cost a sample (the "
                                 "busiest pipe or issue), over every SM at "
                                 "its top clock",
             "samples_needed": samples,
             "design_draws_issue_ms": design_ms,
             "design_draws_note": "diagnostic, not a bound: the samples "
                                  "this design draws (each once for every "
                                  "128-gate block whose window holds it) "
                                  "at its producers' loop SASS cost",
             "design_draws": drawn,
             "design_draw_clocks_per_sample": sass["clocks_per_sample"],
             "bytes_bound_ms": bytes_ms})


def _sm_clocks():
    """(SM clock, its maximum) in MHz, as nvidia-smi reads them."""
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].split(",")
    return tuple(float(c) for c in clocks)


# the f32 schedules' kernels by the profiler's names, and the CUDA-core
# kernels they ran before (now only in scripts/ablate_f32_schedules.py)
F32_SPLIT = (("pc_gemm", "pc_gemm_kernel"), ("pc_drawn", "k4_pc_kernel"),
             ("join", "join_kernel"), ("dft_gemm", "dft_gemm_kernel"),
             ("mix_after", "mix_after_kernel"))
F32_RETIRED = ("band_pc_kernel", "ring_pc_kernel", "mtd_gemm_kernel",
               "mtd_mix_kernel")


def _f32_schedules(nr, plan, lmat, z, seed, errs, launches, card) -> list:
    """The f32 schedules K10, K7 and K9 (``noise_rdm_compact`` on the cube
    ``z``) and K7's draw mode on K1's 3xTF32 GEMMs: busy-card and
    idle-card events, host ms a call, the plain version's time, the
    profiler's split (PC GEMM, join, DFT GEMM, mix-after epilogue, the
    wrapper's casts and pads), which must hold none of the retired
    CUDA-core kernels, and both bounds (3xTF32 on the tensor cores, FP32
    on the CUDA cores). Returns the kernels-line rows."""
    import torch

    num_b = lmat.shape[0]
    planes_c = nr.planes_from_compact(z, plan)
    drawn = nr.philox_planes(plan, seed, num_b, device=z.device)
    n_out = num_b * plan.n_dop * plan.n_gates * 8
    tf32_ms = _k1_bound_ms(plan, num_b, PEAK_TF32, products=3)
    fp32_ms = _k1_bound_ms(plan, num_b)
    # the join reads the PC's four pcT planes [B, G, P4] f32 and writes
    # two; the mix-after reads the DFT's two maps and writes one
    p4 = -(-plan.n_pulses // 4) * 4
    join_ms = 6 * num_b * plan.n_gates * p4 * 4 / PEAK_HBM * 1e3
    mix_after_ms = 3 * n_out / PEAK_HBM * 1e3
    cases = [(name, f"variant={v!r}", rep,
              lambda v=v: nr.noise_rdm_compact(z, plan, lmat, variant=v),
              planes_c, z.numel() * z.element_size(), "pc_gemm")
             for name, v, rep in VARIANTS]
    cases.append(("K7 draw mode", "draw mode (stacked=True)",
                  "radar_tpu/ops/pallas_rdm.py:980 (rolling=True, "
                  "stacked=True)",
                  lambda: nr.noise_rdm(plan, lmat, seed=seed, stacked=True,
                                       layout="bvg"), drawn, 0, "pc_drawn"))
    rows = []
    for name, what, rep, call, planes, n_in, pc_part in cases:
        if name in errs:
            err = errs[name]["f32_max_abs_err"]
        else:
            y, ref = call(), nr.noise_rdm_plain(plan, lmat, planes)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            _require(_rel_rms(y, ref) <= 1e-5, f"{name} (f32) vs plain")
            del y, ref
        ms, pms = _time_pair(call, lambda: nr.noise_rdm_plain(plan, lmat,
                                                              planes))
        busy_ms, host_ms = _busy_event_ms(call)
        prof = _kernel_ms(call, reps=3)
        busy, top = _busy_top(prof)
        split = {k: _named_ms(prof, key) for k, key in F32_SPLIT}
        split = {k: ms_ for k, ms_ in split.items() if ms_ > 0.0}
        split["wrapper"] = busy - sum(split.values())
        retired = [k[:60] for k in prof if any(r in k for r in F32_RETIRED)]
        _line("time", what=repr(f"{name} ({what}, f32) / plain"),
              busy_card_ms=round(busy_ms, 4), idle_card_ms=round(ms, 4),
              host_ms=round(host_ms, 4), plain_ms=round(pms, 4),
              device_busy_ms=round(busy, 4),
              profile_ms={k: round(x, 4) for k, x in split.items()},
              retired_kernels_seen=retired, top_kernels=top,
              bound_3xtf32_ms=round(tf32_ms, 4),
              bound_fp32_ms=round(fp32_ms, 4),
              join_bytes_bound_ms=round(join_ms, 4),
              mix_after_bytes_bound_ms=round(mix_after_ms, 4),
              card=repr(card))
        _require(not retired and all(
            k in split for k in (pc_part, "join", "dft_gemm", "mix_after")),
            f"{name} (f32) ran K1's 3xTF32 GEMMs, the join and the "
            "mix-after epilogue, and no retired CUDA-core kernel")
        bytes_ms = (n_in + n_out) / PEAK_HBM * 1e3
        bound, by = _bound(tf32_ms, bytes_ms)
        rows.append((f"{name} noise RDM, {what}, f32: K1's 3xTF32 "
                     f"{'drawing PC (K4)' if pc_part == 'pc_drawn' else 'PC'}"
                     " and DFT GEMMs, the mix after the DFT",
                     "noise_rdm_sm90.cu", rep, launches[name], err, busy_ms,
                     pms, bound, by, None,
                     {"ms_is": "events around one call, the card kept busy",
                      "idle_card_ms": ms, "host_ms": host_ms,
                      "profile_ms": split,
                      "bound_3xtf32_tensor_cores_ms": tf32_ms,
                      "bound_fp32_cuda_cores_ms": fp32_ms,
                      "bytes_bound_ms": bytes_ms,
                      "join_bytes_bound_ms": join_ms,
                      "mix_after_bytes_bound_ms": mix_after_ms}))
    return rows


def _dft_gemm(nr, plan, planes, launches: int, card) -> tuple:
    """The bf16 DFT GEMM of K10, K7 and K9 alone at full size, on the pc
    planes the strip GEMM makes of ``planes``: held against its plain version
    (D @ pc in f32, rounded) and one bf16 ``torch.matmul`` of the stacked
    real form [[Dr, -Di], [Di, Dr]] @ [pr; pi] (the library yardstick;
    its operands stacked before the timing); busy-card events, host ms.
    Returns its kernels-line row."""
    import torch

    bf = torch.bfloat16
    num_b, num_p = planes[0][0].shape[:2]
    num_v, num_g = plan.n_dop, plan.n_gates
    ld = -(-num_g // 8) * 8
    dev = planes[0][0].device
    pcr = torch.empty((num_b, num_p, ld), dtype=bf, device=dev)
    pci = torch.empty_like(pcr)
    _strip_pc_planes(nr, plan, planes, pcr, pci)
    mtr = torch.empty((num_b, num_v, num_g), dtype=bf, device=dev)
    mti = torch.empty_like(mtr)
    call = lambda: nr.dft(plan, pcr, pci, num_g, mtr, mti)
    pc = torch.complex(pcr[..., :num_g].float(), pci[..., :num_g].float())
    d16 = nr.round_mul(plan.d, bf)
    plain = lambda: nr.round_mul(torch.matmul(d16, pc), bf)
    dst = torch.cat([torch.cat([d16.real, -d16.imag], 1),
                     torch.cat([d16.imag, d16.real], 1)], 0).to(bf)
    pst = torch.cat([pcr[..., :num_g], pci[..., :num_g]], 1)   # [B, 2P, G]
    lib = lambda: torch.matmul(dst, pst)                       # [B, 2V, G]
    call()
    want, got_lib = plain(), lib()
    got = torch.complex(mtr.float(), mti.float())
    torch.cuda.synchronize()
    err = _rel_rms(got, want)
    lib_err = _rel_rms(torch.complex(got_lib[:, :num_v].float(),
                                     got_lib[:, num_v:].float()), want)
    _require(err <= BF16_HOLD and lib_err <= BF16_HOLD,
             "the bf16 DFT GEMM and its library call vs plain")
    ms, pms = _time_pair(call, plain)
    busy_ms, host_ms = _busy_event_ms(call, reps=20)
    lib_ms = statistics.median(_event_ms(lib, 10))
    prof = _named_ms(_kernel_ms(call, reps=10), "dft_kernel")
    macs = num_b * num_v * num_p * num_g
    # pc read once, mt written once (bf16 planes)
    ops_ms = 8.0 * macs / PEAK_BF16 * 1e3
    bytes_ms = _bytes_ms(pcr[..., :num_g], pci[..., :num_g], mtr, mti)
    bound, by = _bound(ops_ms, bytes_ms)
    _line("dft_gemm", card=repr(card), rms_err_over_rms=err,
          library_rms_err_over_rms=lib_err, busy_card_ms=round(busy_ms, 4),
          idle_card_ms=round(ms, 4), host_ms=round(host_ms, 4),
          profile_ms=round(prof, 4), plain_ms=round(pms, 4),
          library_ms=round(lib_ms, 4), ops_bound_ms=round(ops_ms, 4),
          bytes_bound_ms=round(bytes_ms, 4), bound_by=by,
          tflops=round(8.0 * macs / prof / 1e9, 2) if prof > 0.0
          else "not measured (the profiler recorded no dft_kernel)",
          tol=f"<={BF16_HOLD}")
    return ("bf16 DFT GEMM of K10, K7 and K9 (wgmma, B = pc MN-major by "
            "TMA)", "rdm_sm90.cu", "radar_tpu/ops/pallas_rdm.py:789 (the DFT "
            "of _make_kernel_resident; also :627, :1088)", launches,
            float((got - want).abs().max()), busy_ms, pms, bound, by, lib_ms,
            {"ms_is": "events around one call, the card kept busy",
             "idle_card_ms": ms, "host_ms": host_ms, "profile_ms": prof,
             "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms,
             "library_call": "torch.matmul of the stacked real form, bf16"})


def _strip_pc_planes(nr, plan, planes, pcr, pci) -> None:
    """The bf16 pc planes [B, P, ld] of ``planes`` by the strip GEMM."""
    num_b, num_p = planes[0][0].shape[:2]
    nr.strip_pc([(nr._rows16(xr), nr._rows16(xi), seg.strip, seg.j_len,
                  seg.g0) for seg, (xr, xi) in zip(plan.segments, planes)],
                num_b * num_p, pcr.shape[-1], outr=pcr, outi=pci)


def _tails(nr, ck, cfg, pre, ref_cfg, ref_pre, truth, dr, dv, dev, card,
           counts, reset, perf_process) -> dict:
    """Phase ``tails``: one full-width frame of each tail variant, both
    truth targets found in each, with the kernels each must launch; the
    kernel-maps frame's detections against the plain tail on K1's own maps
    (bit for bit) and its mask against the default perf frame's; K1's maps
    epilogue (``add_maps_kernel``) held bit for bit against its plain
    version on the kernel's own unrounded map, with the times and the
    epilogue's bytes bound. Returns row 1's extra keys."""
    import torch

    from radar_tpu_torch.pipeline.frame import (detection_tail,
                                                make_frame_processor,
                                                measure_consts)

    matmul = dataclasses.replace(cfg.cfar, means_impl="matmul")
    branches = (
        ("kernel_maps", cfg.replace(kernel_maps=True), pre,
         ("K1", "K1_maps", "K2")),
        ("kernel_maps_bf16", cfg.replace(kernel_maps=True,
                                         kernel_out_bf16=True), pre,
         ("K1", "K1_maps", "K2")),
        ("kernel_out_bf16", cfg.replace(kernel_out_bf16=True), pre,
         ("K1", "K1_maps", "K2")),
        ("kernel_maps_matmul", cfg.replace(kernel_maps=True, cfar=matmul),
         pre, ("K1", "K1_maps")),
        ("beams_major_prng", cfg.replace(beams_major_tail=True), pre,
         ("K1",)),
        ("beams_major_pallas", cfg.replace(beams_major_tail=True,
                                           noise_rdm_impl="pallas"), pre,
         ("K1",)),
        ("perf_matmul", cfg.replace(cfar=matmul), pre, ("K1",)),
        ("ref_tail_from_rdm", ref_cfg.replace(tail_from_rdm=True), ref_pre,
         ("K3",)),
        ("ref_native_scan", ref_cfg.replace(extract_native_scan=True),
         ref_pre, ("K3",)),
        ("ref_monopulse_complex_pair_mode", ref_cfg.replace(
            monopulse_complex=True, cluster=dataclasses.replace(
                ref_cfg.cluster, keep_pair_mode=True)), ref_pre, ("K3",)),
        ("ref_monopulse_refined", ref_cfg.replace(monopulse_refined=True),
         ref_pre, ("K3",)),
        ("ref_matmul", ref_cfg.replace(cfar=dataclasses.replace(
            ref_cfg.cfar, means_impl="matmul")), ref_pre, ()))
    procs, launches = {}, {}
    for label, cfg_t, pre_t, want in branches:
        proc = make_frame_processor(cfg_t, pre_t, device=dev)
        proc(1, truth)                     # warm-up outside the count
        torch.cuda.synchronize()
        reset()
        res = proc(20261016, truth)
        torch.cuda.synchronize()
        got = counts()
        rows = _rows(res)
        found = _found(rows, truth, dr, dv)
        _line("tails", branch=label, launches=got,
              num_raw=int(res.num_raw_detections),
              num_final=int(res.num_final), found=found,
              pair_idx=(None if res.targets.pair_idx is None else
                        res.targets.pair_idx[res.targets.valid].tolist()),
              targets=np.round(rows, 3).tolist())
        _require(bool(np.all(np.isfinite(rows))) and all(found),
                 f"tails {label}: both truth targets found")
        _require(all(got[k] >= 1 for k in want),
                 f"tails {label} launched {want}")
        _require(("matmul" not in label or got["K2"] + got["K3"] == 0)
                 and (label.startswith("kernel") or got["K1_maps"] == 0),
                 f"tails {label}: no shift-means CFAR kernel under matmul "
                 "means, K1's maps epilogue only on the kernel-maps and "
                 "bf16 frames")
        procs[label], launches[label] = proc, got

    # the kernel-maps frame: K1's maps through K2 on the card against the
    # plain tail (plain K2) on the CPU on the same map and maps
    lr = procs["kernel_maps"].stages
    rdm, maps_p = lr.noise_rdm_sig(20261016, truth, layout="bvg",
                                   emit_maps=True)
    mc = measure_consts(cfg, pre, device=dev)
    mc_cpu = measure_consts(cfg, pre, device="cpu")
    on_card = detection_tail(cfg, mc, rdm, "bvg", "qvg", maps_p=maps_p)
    plain = detection_tail(cfg, mc_cpu, rdm.cpu(), "bvg", "qvg",
                           maps_p=maps_p.cpu())
    same = {f: bool(torch.equal(getattr(on_card[1], f).cpu(),
                                getattr(plain[1], f)))
            for f in ("v_idx", "r_idx", "pair_idx", "amp", "valid",
                      "count")}
    _same_rows(_rows(on_card[-1]), _rows(plain[-1]), rtol=1e-5)
    # the default perf frame's mask (K2 on |rdm|'s pair sums) against the
    # kernel-maps one on the same map: cells at a threshold tie may differ
    num_v, num_g = rdm.shape[1:]
    mag = rdm.abs()
    mask_d, _ = ck.goca_cfar_qvg(ck.pad_maps_qvg(mag[:-1] + mag[1:]),
                                 cfg.cfar, num_g, num_v)
    mask_k, _ = ck.goca_cfar_qvg(maps_p, cfg.cfar, num_g, num_v)
    maps_i = maps_p[:, :num_v, ck.HALO:ck.HALO + num_g]
    maps_rel = float(((maps_i - (mag[:-1] + mag[1:])).abs()
                      / (mag[:-1] + mag[1:])).max())
    _line("tails_kernel_maps", detections_equal_plain=same,
          mask_cells_differing_from_default=int((mask_d != mask_k).sum()),
          hits=int(mask_k.sum()), maps_vs_abs_max_rel=maps_rel,
          shape=[num_v, num_g])
    _require(all(same.values()), "kernel-maps tail == plain tail on K1's "
             "maps, detections bit for bit")

    # K1's epilogue: with maps (f32 and bf16 output) against the plain
    # epilogue on the kernel's own unrounded map, bit for bit
    plan, lmat = lr.rplan, lr.l_factor
    factors = lr.signal_factors(truth)
    seed = nr.seed_words(20261016)
    base = nr.noise_rdm(plan, lmat, factors, seed=seed, layout="bvg")
    checks = {}
    for out_dtype in (torch.float32, torch.bfloat16):
        before = nr.maps_launch_count
        y, m = nr.noise_rdm(plan, lmat, factors, seed=seed, layout="bvg",
                            emit_maps=True, out_dtype=out_dtype)
        torch.cuda.synchronize()
        checks[str(out_dtype)] = {
            "map_equal_rounded_base": bool(torch.equal(
                y, nr.round_mul(base, out_dtype))),
            "maps_equal_plain": bool(torch.equal(m,
                                                 nr.pair_maps_plain(base))),
            "maps_max_abs_err": float((m - nr.pair_maps_plain(base)).abs()
                                      .max()),
            "epilogue_launches": nr.maps_launch_count - before}
    _line("tails_k1_maps", checks=checks,
          tol="bit for bit: the map (rounded to bf16 values) and the maps "
              "of the unrounded map, halo and padding zero")
    _require(all(c["map_equal_rounded_base"] and c["maps_equal_plain"]
                 and c["epilogue_launches"] == 1 for c in checks.values()),
             "K1's maps epilogue == plain, bit for bit")

    # times: the frames (device busy by the profiler, events), K1 with and
    # without the maps, the epilogue beside add_kernel
    frame_busy = {}
    for label, proc in (("default", perf_process),
                        ("kernel_maps", procs["kernel_maps"]),
                        ("kernel_maps_bf16", procs["kernel_maps_bf16"]),
                        ("beams_major_prng", procs["beams_major_prng"])):
        call = lambda p=proc: p(20261016, truth)
        busy, top = _device_busy_ms(call, reps=3)
        frame_busy[label] = {
            "device_busy_ms": round(busy, 4),
            "events_ms": round(statistics.median(_event_ms(call, 5)), 4),
            "top": top[:3]}
    k1_call = lambda: nr.noise_rdm(plan, lmat, factors, seed=seed,
                                   layout="bvg")
    km_call = lambda: nr.noise_rdm(plan, lmat, factors, seed=seed,
                                   layout="bvg", emit_maps=True)
    bf_call = lambda: nr.noise_rdm(plan, lmat, factors, seed=seed,
                                   layout="bvg", emit_maps=True,
                                   out_dtype=torch.bfloat16)
    k1_busy = _busy_event_ms(k1_call)[0]
    km_busy, km_host = _busy_event_ms(km_call)
    bf_busy = _busy_event_ms(bf_call)[0]
    k1_busy_2 = _busy_event_ms(k1_call)[0]
    add_ms = _named_ms(_kernel_ms(k1_call), "add_kernel")
    epi_ms = _named_ms(_kernel_ms(km_call), "add_maps_kernel")
    epi_bf_ms = _named_ms(_kernel_ms(bf_call), "add_maps_kernel")
    num_b = lmat.shape[0]
    # bytes: out and the DFT's correction read, out and the maps' interior
    # written, each once
    epi_bytes = (3 * num_b * num_v * num_g * 8
                 + (num_b - 1) * num_v * num_g * 4)
    epi_bound = epi_bytes / PEAK_HBM * 1e3
    _line("tails_times", card=repr(card), frames=frame_busy,
          k1_busy_card_ms=round(k1_busy, 4),
          k1_again_busy_card_ms=round(k1_busy_2, 4),
          k1_emit_maps_busy_card_ms=round(km_busy, 4),
          k1_emit_maps_host_ms=round(km_host, 4),
          k1_emit_maps_bf16_busy_card_ms=round(bf_busy, 4),
          add_kernel_ms=round(add_ms, 5),
          add_maps_kernel_ms=round(epi_ms, 5),
          add_maps_kernel_bf16_ms=round(epi_bf_ms, 5),
          epilogue_bytes=epi_bytes, epilogue_bound_ms=round(epi_bound, 5))
    _require(epi_ms > 0.0 and add_ms > 0.0,
             "the profiler saw add_maps_kernel and add_kernel")
    return {"emit_maps_busy_card_ms": km_busy,
            "emit_maps_host_ms": km_host,
            "emit_maps_bf16_busy_card_ms": bf_busy,
            "emit_maps_epilogue_ms": epi_ms,
            "emit_maps_epilogue_bf16_ms": epi_bf_ms,
            "add_kernel_ms": add_ms,
            "emit_maps_epilogue_bound_ms": epi_bound,
            "emit_maps_epilogue_bound_by": "bytes",
            "emit_maps_max_abs_err": max(c["maps_max_abs_err"]
                                         for c in checks.values()),
            "emit_maps_launches_kernel_maps_frame":
                launches["kernel_maps"]["K1_maps"],
            "kernel_maps_frame_device_busy_ms":
                frame_busy["kernel_maps"]["device_busy_ms"],
            "default_frame_device_busy_ms":
                frame_busy["default"]["device_busy_ms"]}


def _pc_study(nr, ref_cfg, ref_pre, dev, card) -> list:
    """Phase ``pc_study``: ``scripts/bench_pc2d.py``'s three chains at full
    size (white z -> PC -> MTD with bf16 operands -> mix): the cuBLAS banded
    chain over the compact noise plan, the flat 2D chain, and K8. Holds K8
    against its plain version and the f32 banded-matmul PC at both multiply
    types. Returns the kernels-line rows of K8 at bf16 and at f32."""
    import torch

    from radar_tpu_torch.ops.mtd import make_mtd_matrix
    from radar_tpu_torch.ops.precision import einsum_complex_bf16
    from radar_tpu_torch.ops.pulse_compression import (compact_noise_plan,
                                                       make_matmul_plan,
                                                       pulse_compress_matmul,
                                                       to_device)
    from radar_tpu_torch.studies import pallas_pc as ppc

    bf, f32 = torch.bfloat16, torch.float32
    num_p, num_b = ref_cfg.sig.prt_num, ref_cfg.sig.beam_num
    nplan_np, nlen = compact_noise_plan(make_matmul_plan(ref_pre))
    nplan = to_device(nplan_np, dev)
    pplan = ppc.make_pallas_pc_plan(ref_pre, device=dev)
    _require(pplan.s_compact == nlen, "one compact layout")
    mtd_m = torch.as_tensor(make_mtd_matrix(ref_pre.mtd_win, num_p)).to(
        dev, torch.complex64)
    rng = np.random.default_rng(0)
    l_t = torch.as_tensor(((rng.normal(size=(num_b, num_b))
                            + 1j * rng.normal(size=(num_b, num_b))) * 0.1
                           ).astype(np.complex64)).to(dev)
    g = torch.Generator(device=dev).manual_seed(5)
    z = torch.complex(torch.randn((num_b, num_p, nlen), generator=g,
                                  device=dev),
                      torch.randn((num_b, num_p, nlen), generator=g,
                                  device=dev)) * float(np.sqrt(0.5))
    z_psb = z.permute(1, 2, 0).contiguous()           # [P, S, B]
    z_flat = z.reshape(num_b * num_p, nlen)

    def chain_psb():
        pcz = pulse_compress_matmul(z_psb, nplan, precision="bf16")
        rdmz = einsum_complex_bf16("vp,pjb->vjb", mtd_m, pcz)
        return torch.einsum("vjb,cb->vjc", rdmz, l_t)

    def chain_flat2d():
        pcz = torch.cat([einsum_complex_bf16("rw,wj->rj",
                                             z_flat[:, w0:w0 + wlen], m)
                         for w0, wlen, m in nplan.chunks], dim=1)
        rdmz = einsum_complex_bf16("vp,bpj->bvj", mtd_m,
                                   pcz.reshape(num_b, num_p, -1))
        return torch.einsum("cb,bvj->vjc", l_t, rdmz)

    def chain_pallas_pc():
        rdmz = einsum_complex_bf16("vp,bpj->bvj", mtd_m,
                                   ppc.pulse_compress_noise(z, pplan))
        return torch.einsum("cb,bvj->vjc", l_t, rdmz)

    chains = {"chain_PSB": chain_psb, "chain_flat2d": chain_flat2d,
              "chain_pallas_pc": chain_pallas_pc}
    ppc.launch_count = ppc.stage_launch_count = nr.strip_pc_launch_count = 0
    out = {name: fn() for name, fn in chains.items()}
    torch.cuda.synchronize()
    launches = ppc.launch_count
    parts = (ppc.stage_launch_count, nr.strip_pc_launch_count)
    ms = {name: statistics.median(_event_ms(fn, 5))
          for name, fn in chains.items()}
    vs = {name: _rel_rms(y, out["chain_PSB"]) for name, y in out.items()}
    _line("pc_study", launches_K8=launches,
          launches_stage_and_strip_gemm=parts, ms=ms, rms_vs_chain_PSB=vs,
          card=repr(card), tol="<=1e-2")
    _require(launches == 1 and parts == (1, 1)
             and all(v <= 1e-2 for v in vs.values()),
             "the three chains agree and chain_pallas_pc launched K8 "
             "(its staging kernel and strip GEMM)")
    del out

    errs = {}
    for label, md, tol in (("f32", f32, 1e-5), ("bf16", bf, 1e-4)):
        got = ppc.pulse_compress_noise(z, pplan, mul_dtype=md)
        ref = ppc.pulse_compress_noise_plain(z, pplan, mul_dtype=md)
        torch.cuda.synchronize()
        errs[label] = (_rel_rms(got, ref), float((got - ref).abs().max()))
        _require(errs[label][0] <= tol, f"K8 ({label}) vs plain")
        if md == f32:
            mm = pulse_compress_matmul(z_psb, nplan).permute(2, 0, 1)
            errs["f32_vs_matmul"] = _rel_rms(got, mm)
            _require(errs["f32_vs_matmul"] <= 1e-5, "K8 f32 vs matmul PC")
        del got, ref
    _line("pc_study", K8_vs_plain=errs,
          tol="f32 <=1e-5, bf16 <=1e-4, f32 vs matmul <=1e-5 (rms rel)")

    lib_ms = _library_ms(z, pplan, bf)
    k8_ms, k8_plain_ms = _time_pair(
        lambda: ppc.pulse_compress_noise(z, pplan),
        lambda: ppc.pulse_compress_noise_plain(z, pplan))
    _line("pc_study", chain_pallas_pc_profile=_device_busy_ms(
        chain_pallas_pc, reps=3), card=repr(card))
    _line("time", what=repr("K8 (bf16) / plain / library (3 bf16 "
                            "torch.matmul calls)"), ms=round(k8_ms, 4),
          plain_ms=round(k8_plain_ms, 4), library_ms=round(lib_ms, 4),
          card=repr(card))
    macs = num_b * num_p * sum(sg.j_len * sg.taps for sg in pplan.segments)
    # z read once, the complex64 PC written once
    k8_bytes_ms = ((z.numel() + num_b * num_p * pplan.n_gates) * 8
                   / PEAK_HBM * 1e3)
    bound, by = _bound(8.0 * macs / PEAK_BF16 * 1e3, k8_bytes_ms)
    row32 = _k8_f32(ppc, pplan, z, macs, k8_bytes_ms, card)

    # K8's two kernels (profiler) and the strip GEMM's rate over the band
    # it walks (128-row x 128-gate blocks, k to the strip's padded depth)
    # and over the convolution's own MACs, 8 FLOPs a complex MAC
    split = _kernel_ms(lambda: ppc.pulse_compress_noise(z, pplan), reps=5)
    stage_ms = _named_ms(split, "stage_kernel")
    gemm_ms = _named_ms(split, "strip_pc_kernel")
    _require(stage_ms > 0.0 and gemm_ms > 0.0,
             "the profiler saw K8's staging kernel and strip GEMM")
    # K8's events on a card kept busy and the host's time per call: on an
    # idle card the events also hold the host work before the first launch
    busy, host = _busy_event_ms(lambda: ppc.pulse_compress_noise(z, pplan))
    rows = num_b * num_p
    walked = sum(-(-rows // 128) * 128 * -(-sg.j_len // 128) * 128
                 * sg.strip.shape[2] for sg in pplan.segments)
    rate = {"stage_ms": stage_ms, "gemm_ms": gemm_ms,
            "busy_card_ms": busy, "host_ms": host,
            "gemm_tflops_band": 8.0 * walked / gemm_ms / 1e9,
            "gemm_tflops_direct": 8.0 * macs / gemm_ms / 1e9,
            "band_gflop": 8.0 * walked / 1e9,
            "direct_gflop": 8.0 * macs / 1e9}
    _line("pc_study", K8_split={k: round(v, 4) for k, v in rate.items()},
          other_ms=round(sum(split.values()) - stage_ms - gemm_ms, 4),
          bound_ms=round(bound, 4), bound_by=by, card=repr(card))
    return [("K8 banded PC of white noise (study), bf16 operands: staging "
             "+ strip GEMM", "band_pc_sm90.cu",
             "radar_tpu/studies/pallas_pc.py:150", launches, errs["bf16"][1],
             k8_ms, k8_plain_ms, bound, by, lib_ms, rate), row32]


def _library_ms(z, pplan, dtype) -> float:
    """K8's library yardstick: ms of one ``dtype`` torch.matmul per segment
    of the stacked windows [B, nt, 2P, W] with [Mr | Mi] [W, 2T] (the
    operands made before the timing)."""
    import torch

    lib_in = []
    for seg in pplan.segments:
        nt = -(-seg.j_len // seg.tile)
        pad = lambda x: torch.nn.functional.pad(
            x[:, :, seg.c0:seg.c0 + seg.r_len], (seg.pad_front, seg.pad_tail))
        win = lambda x: pad(x).unfold(-1, seg.window, seg.tile)[:, :, :nt]
        x2 = torch.cat([win(z.real), win(z.imag)], dim=1).to(dtype)
        lib_in.append((x2.permute(0, 2, 1, 3).contiguous(),
                       torch.cat([seg.mr, seg.mi], dim=1).to(dtype)))
    return statistics.median(_event_ms(
        lambda: [torch.matmul(x, m) for x, m in lib_in], 10))


def _k8_f32(ppc, pplan, z, macs: int, bytes_ms: float, card) -> tuple:
    """K8 at f32 (the staging kernel's f32 planes, then K1's 3xTF32 strip
    GEMM with both passes in one launch, ``k8_pc_kernel``) at full size:
    one staging and one GEMM launch a call, busy and idle card, host ms,
    the plain version, the profiler's split (staging, GEMM), both bounds
    (3xTF32 on the tensor cores, FP32 on the CUDA cores) and the library
    yardstick (one f32 ``torch.matmul`` a segment of the windows with [Mr
    | Mi], full f32). Returns its kernels-line row."""
    import torch

    f32 = torch.float32
    call = lambda: ppc.pulse_compress_noise(z, pplan, mul_dtype=f32)
    ppc.launch_count = ppc.stage_launch_count = ppc.tf32_pc_launch_count = 0
    got = call()
    torch.cuda.synchronize()
    launches = (ppc.launch_count, ppc.stage_launch_count,
                ppc.tf32_pc_launch_count)
    ref = ppc.pulse_compress_noise_plain(z, pplan, mul_dtype=f32)
    err = float((got - ref).abs().max())
    del got, ref
    _require(launches == (1, 1, 1), "K8 at f32 ran its staging kernel and "
             "the 3xTF32 strip GEMM once")
    ms, plain_ms = _time_pair(call, lambda: ppc.pulse_compress_noise_plain(
        z, pplan, mul_dtype=f32))
    busy, host = _busy_event_ms(call)
    prof = _kernel_ms(call, reps=5)
    split = {"stage": _named_ms(prof, "stage_kernel"),
             "gemm_3xtf32": _named_ms(prof, "k8_pc_kernel")}
    retired = [k[:60] for k in prof if "band_pc_kernel" in k]
    _require(all(v > 0.0 for v in split.values()) and not retired,
             "the profiler saw K8's f32 staging and 3xTF32 GEMM, no "
             "CUDA-core PC")
    lib_ms = _library_ms(z, pplan, f32)
    tf32_ms = 24.0 * macs / PEAK_TF32 * 1e3
    fp32_ms = 8.0 * macs / PEAK_FP32 * 1e3
    bound, by = _bound(tf32_ms, bytes_ms)
    _line("time", what=repr("K8 (f32: staging + 3xTF32 strip GEMM) / plain "
                            "/ library (3 f32 torch.matmul calls)"),
          busy_card_ms=round(busy, 4), idle_card_ms=round(ms, 4),
          host_ms=round(host, 4), plain_ms=round(plain_ms, 4),
          library_ms=round(lib_ms, 4),
          profile_ms={k: round(v, 4) for k, v in split.items()},
          bound_3xtf32_ms=round(tf32_ms, 4), bound_fp32_ms=round(fp32_ms, 4),
          bytes_bound_ms=round(bytes_ms, 4), launches=launches,
          card=repr(card))
    return ("K8 banded PC of white noise (study), f32 operands: f32 staging "
            "+ K1's 3xTF32 strip GEMM, both passes in one launch",
            "noise_rdm_sm90.cu", "radar_tpu/studies/pallas_pc.py:150 "
            "(mul_dtype=f32)", launches[0], err, busy, plain_ms, bound, by,
            lib_ms,
            {"ms_is": "events around one call, the card kept busy",
             "idle_card_ms": ms, "host_ms": host, "profile_ms": split,
             "bound_3xtf32_tensor_cores_ms": tf32_ms,
             "bound_fp32_cuda_cores_ms": fp32_ms, "bytes_bound_ms": bytes_ms,
             "library_call": "3 f32 torch.matmul calls (one a segment) of "
                             "the stacked windows with [Mr | Mi]"})


MULTICHIP_RANKS = 4
SLEEP_CYCLES = 4_000_000     # torch.cuda._sleep ahead of a timed call: ~2 ms


def _same(a: dict, b: dict, rtol: float = 0.0) -> bool:
    """Two host FrameResults (``dryrun.host_result``): counts and valid
    slots equal, the valid slots' fields equal (``rtol`` 0) or within
    ``rtol``."""
    if any(not np.array_equal(a[k], b[k])
           for k in ("num_raw", "num_final", "valid")):
        return False
    v = np.asarray(b["valid"], bool)
    return all(np.allclose(a[f][v], b[f][v], rtol=rtol, atol=0.0)
               if rtol else np.array_equal(a[f][v], b[f][v])
               for f in ("range_m", "velocity_ms", "angle_deg", "power"))


def _multichip_rank() -> dict:
    """Body of each rank of phase ``multichip`` (``run_ranks``): the arms of
    ``__graft_entry__.py::dryrun_multichip`` with the single-rank runs they
    must equal, K6 at the full-width range-sharded PC, and CUDA-event times
    of K6, its plain version, the library copy and the sharded PC. The
    launch counters are set to 0 just before each arm and read after."""
    import torch
    import torch.distributed as dist

    from radar_tpu_torch.config.params import full_config, perf_config
    from radar_tpu_torch.ops import awgn as k5
    from radar_tpu_torch.ops import cfar_kernel as ck
    from radar_tpu_torch.ops import noise_rdm as nr
    from radar_tpu_torch.parallel import pallas_ring as ring
    from radar_tpu_torch.parallel.collectives import (
        gather_along, pulse_compress_range_sharded, shard_along)
    from radar_tpu_torch.parallel.dp import (broadcast_targets,
                                             make_dp_frame_processor,
                                             make_dp_sharded_frame_processor)
    from radar_tpu_torch.parallel.dryrun import host_result
    from radar_tpu_torch.parallel.mesh import make_mesh
    from radar_tpu_torch.parallel.sharded import make_sharded_frame_processor
    from radar_tpu_torch.pipeline.driver import frame_seed
    from radar_tpu_torch.pipeline.frame import make_frame_processor
    from radar_tpu_torch.pipeline.montecarlo import snr_sweep
    from radar_tpu_torch.pipeline.streaming import run_streaming_mc
    from radar_tpu_torch.sim.scenario import TargetBatch
    from radar_tpu_torch.waveform.precompute import precompute

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = dist.get_rank(), dist.get_world_size()
    c64 = torch.complex64
    counts = lambda: {"K1": nr.launch_count, "K2": ck.launch_count,
                      "K3": ck.k3_launch_count, "K5": k5.launch_count,
                      "K6": ring.k6_launch_count,
                      "K6_fill": ring.k6_fill_count}

    def reset():
        nr.launch_count = ck.launch_count = ck.k3_launch_count = 0
        k5.launch_count = ring.k6_launch_count = ring.k6_fill_count = 0

    truth = TargetBatch.make([3000.0, 10000.0], [20.0, 25.0], [10.0, 10.0],
                             [10.0, 15.0])
    out = {"rank": rank}
    t_rank = time.perf_counter()

    # ---- range_rdma: a full frame's beams (13 x 332 rows) x 5819 samples,
    # zero-padded to 4 x 1455, through the long segment's matched filter
    ring_mesh = make_mesh(cpi=world)
    dev = ring_mesh.device
    out["transport"] = {"backend": ring_mesh.backend,
                        "staging": ring_mesh.staging, "device": str(dev)}
    full = full_config()
    pre = precompute(full)
    rows = full.sig.beam_num * full.sig.prt_num
    num_s = full.sig.point_prt
    s_pad = -(-num_s // world) * world
    taps = np.ascontiguousarray(pre.mf_long_win)
    halo, nfft = len(taps) - 1, 4096
    g = torch.Generator(device=dev).manual_seed(20261016)
    x = torch.randn((rows, num_s), dtype=c64, generator=g, device=dev)
    xl = shard_along(torch.cat([x, x.new_zeros((rows, s_pad - num_s))], 1),
                     ring_mesh, "cpi", 1)
    f_pp = pulse_compress_range_sharded(ring_mesh, taps, nfft,
                                        halo_impl="ppermute")
    f_rd = pulse_compress_range_sharded(ring_mesh, taps, nfft,
                                        halo_impl="rdma")
    f_rd(xl)                               # sets up K6; outside the count
    torch.cuda.synchronize()
    reset()
    y_rd = f_rd(xl)
    torch.cuda.synchronize()
    launches = counts()
    y_pp = f_pp(xl)
    ex = f_rd.exchange
    k6_halo = ex(xl)
    plain_halo = ring.halo_right_plain(xl, ring_mesh, halo)
    arm = {"launches": launches, "shape": [rows, xl.shape[1], halo, 8, nfft],
           "halo_identical": bool(torch.equal(k6_halo, plain_halo)),
           "halo_max_abs_err": float((k6_halo - plain_halo).abs().max()),
           "halo_nonzero": bool(plain_halo.abs().max() > 0),
           "output_identical": bool(torch.equal(y_rd, y_pp))}
    plain_in = ring.overlap_save_input_plain(xl, ring_mesh, halo, nfft)
    arm["os_input_identical"] = bool(torch.equal(
        ex.overlap_save_input(xl), plain_in))
    y = gather_along(y_rd, ring_mesh, "cpi", 1)[:, :num_s]
    if rank == 0:
        hf = torch.fft.fft(torch.as_tensor(taps).to(dev, c64), n=8192)
        ref = torch.fft.ifft(torch.fft.fft(x, n=8192) * hf)[:, :num_s]
        arm["err_over_max"] = float((y - ref).abs().max()
                                    / ref.abs().max())
    ex.check()
    del y, x, plain_in

    def in_turns(fn) -> None:
        """``fn`` on one rank at a time, the others waiting at a barrier."""
        for turn in range(world):
            ring_mesh.barrier("cpi")
            if turn == rank:
                fn()
                torch.cuda.synchronize()

    def event_ms(fn, busy: bool, ts: list, host: list | None) -> None:
        """``_one_event_ms`` of ``fn`` into ``ts`` (its host ms into
        ``host``)."""
        dev_ms, host_ms = _one_event_ms(fn, busy)
        ts.append(dev_ms)
        if host is not None:
            host.append(host_ms)

    def timed(fn, reps: int = 7, turns: bool = False, before_rep=None,
              after_rep=None, busy: bool = False,
              host: list | None = None) -> float:
        """Median CUDA-event ms of ``fn`` on this rank, the ranks aligned by
        a barrier: all at once, or (``turns``) one rank at a time with the
        others idle; ``before_rep`` and ``after_rep`` (untimed) begin and
        end each round, behind a barrier."""
        ts = []
        for _ in range(reps):
            if before_rep is not None:
                ring_mesh.barrier("cpi")
                before_rep()
            for turn in (range(world) if turns else [rank]):
                ring_mesh.barrier("cpi")
                if turn == rank:
                    event_ms(fn, busy, ts, host)
            if after_rep is not None:
                ring_mesh.barrier("cpi")
                after_rep()
        return statistics.median(ts)

    def exchange_turns(call, reps: int = 3, busy: bool = False,
                       host: list | None = None) -> float:
        """Median event ms of ``call``, one whole exchange (a push, then a
        receive that waits for the left neighbour's push), on this rank,
        one rank at a time: in round q rank q pushes first, then every
        other rank in ring order exchanges alone (its left neighbour has
        pushed), then rank q fills. The ring's dependencies form a cycle,
        so each round times every rank but one."""
        ts = []
        for q in range(reps * world):
            q %= world
            ring_mesh.barrier("cpi")
            if rank == q:
                ex.push(xl)
                torch.cuda.synchronize()
            for t in range(1, world):
                ring_mesh.barrier("cpi")
                if (q + t) % world == rank:
                    event_ms(call, busy, ts, host)
            ring_mesh.barrier("cpi")
            if rank == q:
                ex.fill(xl)
                torch.cuda.synchronize()
        return statistics.median(ts)

    def kernel_ms(fn, names=(None,), reps: int = 7, before_rep=None,
                  after_rep=None) -> dict:
        """Device ms per round of the kernels whose name holds each of
        ``names`` (all kernels for None), from torch.profiler, ``fn`` run
        one rank at a time inside ``timed``'s rounds (the kernels of
        ``before_rep`` and ``after_rep`` counted too)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            timed(fn, reps, turns=True, before_rep=before_rep,
                  after_rep=after_rep)
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        dev_t = lambda e: getattr(e, "self_device_time_total",
                                  getattr(e, "self_cuda_time_total", 0))
        return {n: sum(dev_t(e) for e in evs if n is None or n in e.key)
                / reps / 1000.0 for n in names}

    # K6 one rank at a time, so no kernel shares the card with another
    # rank's: CUDA events with the card kept busy (device time), and idle
    # (with the host's ms a call); the push in rounds of pushes then fills,
    # the fill in rounds of pushes then fills, a whole exchange in
    # exchange_turns' rounds. Beside it the FFT input built through the
    # [rows, halo] contract (push, fill, a copy of the halo, cat and the
    # FFT's zero pad; the old pull kernel is timed in
    # scripts/ablate_ring.py). The library yardstick: one copy_ of the
    # halo into the right neighbour's receive slot (rows nfft apart, as the
    # push writes them), on the card that holds it (ranks on separate
    # cards: a peer copy), and one copy_ of the same bytes between
    # contiguous tensors. The profiler splits the builds into kernels.
    push = lambda: ex.push(xl)
    fill = lambda: ex.fill(xl)
    pushes, fills = (lambda: in_turns(push)), (lambda: in_turns(fill))
    new_build = lambda: ex.overlap_save_input(xl)
    s_pad_cols = nfft - halo - xl.shape[1]
    halo_build = lambda: torch.nn.functional.pad(
        torch.cat([ex(xl), xl], -1), (0, s_pad_cols))
    peer, src = ex.peer_slot_view(), xl[:, xl.shape[1] - halo:]
    flat_src, flat_dst = torch.empty_like(k6_halo), torch.empty_like(k6_halo)
    copy, copy_flat = (lambda: peer.copy_(src)), (lambda: flat_dst.copy_(
        flat_src))
    host = {k: [] for k in ("push", "fill", "exchange", "copy")}
    k6 = kernel_ms(push, ("push_kernel", "fill_kernel", None),
                   after_rep=fills)
    arm["ms"] = {
        "K6": exchange_turns(new_build, busy=True),
        "K6_push": timed(push, turns=True, after_rep=fills, busy=True),
        "K6_fill": timed(fill, turns=True, before_rep=pushes, busy=True),
        "fft_input_build_cat_pad": exchange_turns(halo_build, busy=True),
        "K6_exchange_idle": exchange_turns(new_build, host=host["exchange"]),
        "K6_push_idle": timed(push, turns=True, after_rep=fills,
                              host=host["push"]),
        "K6_fill_idle": timed(fill, turns=True, before_rep=pushes,
                              host=host["fill"]),
        "K6_push_profiler": k6["push_kernel"],
        "K6_fill_profiler": k6["fill_kernel"],
        "fft_input_build_profiler": k6[None],
        "K6_exchange_all_ranks": timed(new_build),
        "plain_os_input": timed(lambda: ring.overlap_save_input_plain(
            xl, ring_mesh, halo, nfft)),
        "library_copy": timed(copy, turns=True, busy=True),
        "library_copy_idle": timed(copy, turns=True, host=host["copy"]),
        "library_copy_contiguous": timed(copy_flat, turns=True, busy=True)}
    # the copies wrote into the first rank's slot, whose halo columns K6
    # leaves at the causal edge's zeros: zero them again
    if (rank + 1) % world == 0:
        peer.zero_()
    torch.cuda.synchronize()
    arm["ms"]["pc_rdma"] = timed(lambda: f_rd(xl))
    arm["ms"]["pc_ppermute"] = timed(lambda: f_pp(xl))
    for k, v in host.items():
        arm["ms"][f"{k}_host"] = statistics.median(v)
    ex.check()
    ring_mesh.barrier("cpi")
    f_rd.close()
    out["range_rdma"] = arm
    del y_rd, y_pp, k6_halo, plain_halo, xl, peer, src, flat_src, flat_dst

    # ---- perf_dp_fused / perf_dp_xla: a batch of 4 full frames at dp=4;
    # rank r checks frame r+1 against its own single-rank frame
    dp_mesh = make_mesh(dp=world)
    seeds = [frame_seed(20261016, i) for i in range(world)]
    batch_targets = broadcast_targets(truth, world)
    perf = perf_config()
    pre_p = precompute(perf)
    j = (rank + 1) % world
    for label, cfg in (("perf_dp_fused", perf),
                       ("perf_dp_xla", perf_config(pallas=False))):
        proc = make_dp_frame_processor(cfg, dp_mesh, pre_p)
        proc(seeds, batch_targets)         # warm-up outside the count
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        batch = host_result(proc(seeds, batch_targets))
        wall = time.perf_counter() - t0
        got = counts()
        single = host_result(make_frame_processor(cfg, pre_p, device=dev)(
            seeds[j], truth))
        out[label] = {"launches": got, "batch_ms": 1e3 * wall,
                      "exact": _same({k: v[j] for k, v in batch.items()},
                                     single),
                      "batch": batch if rank == 0 else None}

    # ---- stream / lowrank: one full frame sharded over (1, 2, 2)
    mesh_122 = make_mesh(1, 2, 2)
    for label, cfg in (("stream", full),
                       ("lowrank", full.replace(fused_synth_dbf=True,
                                                lowrank_rdm=True))):
        pre_c = pre if label == "stream" else precompute(cfg)
        proc = make_sharded_frame_processor(cfg, mesh_122, pre_c)
        proc(1, truth)                     # warm-up outside the count
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        res = host_result(proc(20261016, truth))
        wall = time.perf_counter() - t0
        out[label] = {"launches": counts(), "frame_ms": 1e3 * wall,
                      "result": res}
        if rank == 0:
            out[label]["single"] = host_result(make_frame_processor(
                cfg, pre_c, device=dev)(20261016, truth))

    # ---- dp_x_model: dp=2 x ch=2, a batch of 4 full frames
    proc = make_dp_sharded_frame_processor(full, make_mesh(dp=2, ch=2),
                                           pre)
    seeds7 = [frame_seed(7, i) for i in range(4)]
    targets4 = broadcast_targets(truth, 4)
    proc([frame_seed(8, i) for i in range(4)], targets4)   # warm-up
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    batch = host_result(proc(seeds7, targets4))
    wall = time.perf_counter() - t0
    launches = counts()
    single = host_result(make_frame_processor(full, pre, device=dev)(
        seeds7[rank], truth))
    out["dp_x_model"] = {
        "launches": launches, "batch_ms": 1e3 * wall,
        "same": _same({k: v[rank] for k, v in batch.items()}, single,
                      rtol=1e-4),
        "num_final": batch["num_final"].tolist()}

    # ---- mc_dp: the perf sweep and a small streaming MC at dp=4
    reset()
    t0 = time.perf_counter()
    sw = snr_sweep(perf, [0.0, 20.0], num_trials=16, mesh=dp_mesh,
                   precomp=pre_p)
    sw_wall = time.perf_counter() - t0
    sw_launches = counts()
    st_kw = dict(num_scenes=2, targets_per_scene=8, trials_per_scene=4,
                 snr_range=(-5.0, 20.0), precomp=pre_p)
    st = run_streaming_mc(perf, mesh=dp_mesh, dp_trials=True, **st_kw)
    mc = {"launches": sw_launches, "sweep_s": sw_wall,
          "pd": sw.detection_probability.tolist(), "errors": sw.errors,
          "streaming": st}
    if rank == 0:
        mc["sweep_single"] = snr_sweep(perf, [0.0, 20.0], num_trials=16,
                                       precomp=pre_p, device=dev).errors
    if rank == 1:
        mc["streaming_single"] = run_streaming_mc(perf, device=dev, **st_kw)
    out["mc_dp"] = mc

    # ---- doa_cov: music_2d(mesh=) on BASELINE config 4's 16x8 URA, its
    # 512 snapshots sharded over the ranks (the covariance all-reduced)
    from radar_tpu_torch.doa.music import covariance, music_2d, steering_ura
    from radar_tpu_torch.parallel.collectives import \
        covariance_snapshot_sharded

    truth2 = np.array([[12.3, 25.7], [-40.6, 55.4]])
    rng = np.random.default_rng(11)
    a2 = steering_ura(truth2[:, 0], truth2[:, 1], 16, 8, 0.5)
    a2 = np.stack([a2[:, 0], a2[:, 3]], axis=1)
    x = (a2 @ ((rng.normal(size=(2, 512)) + 1j * rng.normal(size=(2, 512)))
               / np.sqrt(2))
         + (rng.normal(size=(128, 512)) + 1j * rng.normal(size=(128, 512)))
         * np.sqrt(0.5) * 0.1).astype(np.complex64)
    az = np.arange(-60.0, 60.0 + 1e-9, 1.0)
    el = np.arange(10.0, 80.0 + 1e-9, 1.0)
    cpi_mesh = make_mesh(cpi=world)
    xl = shard_along(x, cpi_mesh, "cpi", 1)
    kw = dict(az_deg=az, el_deg=el, refine=True)
    music_2d(xl, 2, 16, 8, 0.5, mesh=cpi_mesh, **kw)        # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharded = music_2d(xl, 2, 16, 8, 0.5, mesh=cpi_mesh, **kw)
    doa_ms = (time.perf_counter() - t0) * 1e3
    cov = covariance_snapshot_sharded(cpi_mesh)(xl)
    xd = torch.as_tensor(x, device=dev)
    one = covariance(xd)
    out["doa_cov"] = {
        "cov_err": float((cov - one).abs().max() / one.abs().max()),
        "peaks": sharded.peaks_deg,
        "single_peaks": music_2d(xd, 2, 16, 8, 0.5, **kw).peaks_deg,
        "truth": truth2, "ms": doa_ms}
    out["rank_s"] = time.perf_counter() - t_rank
    return out


def _host_rows(h: dict) -> np.ndarray:
    """Valid final targets of a host FrameResult as rows (range, velocity,
    angle, power)."""
    v = np.asarray(h["valid"], bool)
    return np.stack([h[f][v] for f in ("range_m", "velocity_ms",
                                       "angle_deg", "power")], 1)


def _multichip(card: str, truth, dr: float, dv: float) -> list:
    """Phase ``multichip``: ``_multichip_rank`` on 4 ranks through
    ``run_ranks`` (one card: 4 processes on it, gloo with host-staged plain
    collectives; 4 or more cards: a rank per card on NCCL). Prints one line
    per arm, raises on any failed hold, returns K6's kernels-line row."""
    import torch

    from radar_tpu_torch.parallel.multihost import choose_backend, run_ranks

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,compute_mode",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    _require("Exclusive_Process" not in smi,
             "compute mode Default: ranks sharing a card need several "
             "processes per card, and K6 maps their buffers by CUDA IPC")
    n, cards = MULTICHIP_RANKS, torch.cuda.device_count()
    backend = choose_backend("cuda", n)
    _line("multichip", world_size=n, cards=cards, backend=backend,
          staging=backend == "gloo",
          devices=[f"cuda:{r % cards}" for r in range(n)])
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = run_ranks(_multichip_rank, n, device="cuda", timeout=600)
    wall = time.perf_counter() - t0
    _line("multichip", transport=[r["transport"] for r in res],
          rank_s=[round(r["rank_s"], 2) for r in res])

    rr = [r["range_rdma"] for r in res]
    # medians over the ranks that send data: the last rank's push carries
    # none (its right neighbour's halo is the causal edge's zeros)
    med = lambda key: statistics.median(a["ms"][key] for a in rr[:-1])
    _line("multichip", arm="range_rdma", shape=rr[0]["shape"],
          launches=[a["launches"]["K6"] for a in rr],
          fills=[a["launches"]["K6_fill"] for a in rr],
          halo_identical=[a["halo_identical"] for a in rr],
          os_input_identical=[a["os_input_identical"] for a in rr],
          output_identical=[a["output_identical"] for a in rr],
          err_over_max=rr[0]["err_over_max"],
          ms_per_rank={k: [round(a["ms"][k], 4) for a in rr]
                       for k in rr[0]["ms"]},
          card=repr(card), tol="halo and output identical; 1e-4 of max")
    _require(all(a["launches"]["K6"] == a["launches"]["K6_fill"] == 1
                 for a in rr),
             "range_rdma: one K6 push and one fill per call per rank")
    _require(all(a["halo_identical"] and a["output_identical"]
                 and a["os_input_identical"] for a in rr),
             "range_rdma: K6 == the plain ring (halo, FFT input, output)")
    _require(all(a["halo_nonzero"] for a in rr[1:]),
             "range_rdma: ranks 1-3 received a halo")
    _require(rr[0]["err_over_max"] <= 1e-4,
             "range_rdma: within 1e-4 of the unsharded convolution")

    found = lambda h: _found(_host_rows(h), truth, dr, dv)
    for label, want in (("perf_dp_fused", {"K1": 1, "K2": 1}),
                        ("perf_dp_xla", {"K1": 0, "K2": 1})):
        arms = [r[label] for r in res]
        batch = arms[0]["batch"]
        frames = [{k: v[i] for k, v in batch.items()} for i in range(n)]
        _line("multichip", arm=label, launches=[a["launches"] for a in arms],
              exact=[a["exact"] for a in arms],
              num_final=batch["num_final"].tolist(),
              found=[found(f) for f in frames],
              batch_ms=[round(a["batch_ms"], 3) for a in arms])
        _require(all(a["exact"] for a in arms),
                 f"{label}: every frame == its single-rank frame")
        _require(all(a["launches"][k] == v for a in arms
                     for k, v in want.items()),
                 f"{label}: {want} per rank (one frame each)")
        _require(all(all(found(f)) for f in frames),
                 f"{label}: truth targets found in every frame")

    for label, kernel in (("stream", "K3"), ("lowrank", "K2")):
        arms = [r[label] for r in res]
        single = arms[0]["single"]
        same = [_same(a["result"], single, rtol=1e-4) for a in arms]
        _line("multichip", arm=label, mesh="dp=1,ch=2,cpi=2",
              launches=[a["launches"] for a in arms], same=same,
              num_raw=int(single["num_raw"]),
              num_final=int(single["num_final"]),
              found=found(arms[0]["result"]),
              frame_ms=[round(a["frame_ms"], 3) for a in arms],
              tol="counts exact, fields rtol 1e-4")
        _require(all(same), f"{label}: == the single-rank frame")
        _require(all(a["launches"][kernel] >= 1 for a in arms),
                 f"{label}: the tail launched {kernel}")
        _require(all(found(arms[0]["result"])),
                 f"{label}: truth targets found")

    arms = [r["dp_x_model"] for r in res]
    _line("multichip", arm="dp_x_model", mesh="dp=2,ch=2,cpi=1",
          launches=[a["launches"] for a in arms],
          same=[a["same"] for a in arms], num_final=arms[0]["num_final"],
          batch_ms=[round(a["batch_ms"], 3) for a in arms],
          tol="counts exact, fields rtol 1e-4")
    _require(all(a["same"] for a in arms),
             "dp_x_model: every frame == its single-rank frame")
    _require(all(a["launches"]["K3"] == 2 for a in arms),
             "dp_x_model: K3 twice per rank (4 frames / dp 2)")

    arms = [r["mc_dp"] for r in res]
    sw_same = all(np.array_equal(a["errors"], arms[0]["sweep_single"],
                                 equal_nan=True) for a in arms)
    st1 = res[1]["mc_dp"]["streaming_single"]
    st_same = all(a["streaming"].total_detected == st1.total_detected
                  and np.array_equal(a["streaming"].snr_bin_rate,
                                     st1.snr_bin_rate, equal_nan=True)
                  and a["streaming"].range_rmse_m == st1.range_rmse_m
                  for a in arms)
    _line("multichip", arm="mc_dp", launches=[a["launches"] for a in arms],
          sweep_pd=arms[0]["pd"], sweep_identical=sw_same,
          sweep_s=[round(a["sweep_s"], 3) for a in arms],
          streaming_rate=arms[0]["streaming"].detection_rate,
          streaming_targets=arms[0]["streaming"].total_targets,
          streaming_identical=st_same)
    _require(sw_same and st_same,
             "mc_dp: the dp sweep and streaming MC == the one-rank runs")
    _require(all(a["launches"]["K1"] == 8 for a in arms),
             "mc_dp: 8 K1 trials per rank (2 points x 16 trials / 4)")
    arms = [r["doa_cov"] for r in res]
    by_az = lambda p: p[np.argsort(p[:, 0])]
    peak_err = [float(np.abs(by_az(a["peaks"]) - by_az(a["single_peaks"]))
                      .max()) for a in arms]
    truth_err = [float(np.abs(by_az(a["peaks"]) - by_az(a["truth"])).max())
                 for a in arms]
    _line("multichip", arm="doa_cov", mesh=f"cpi={n}", shape=[128, 512],
          cov_err_over_max=[a["cov_err"] for a in arms],
          peaks_vs_one_rank_deg=peak_err, peaks_vs_truth_deg=truth_err,
          music_2d_refine_ms=[round(a["ms"], 3) for a in arms],
          tol="covariance 1e-5 of max; peaks within 0.05 deg (zoom step) "
              "of one rank's, 0.15 of the truth")
    _require(all(a["cov_err"] <= 1e-5 for a in arms),
             "doa_cov: the sharded covariance == one rank's")
    _require(max(peak_err) <= 0.05 + 1e-9 and max(truth_err) <= 0.15,
             "doa_cov: the sharded MUSIC finds one rank's peaks")
    _line("multichip", wall_s=round(wall, 2), card=repr(card))

    # K6 on the main path: the push reads the halo once and writes it once
    # (both on one card, or the write over NVLink when every rank has its
    # own card), the fill reads the shard once and writes it once
    rows, s_local, halo, esize, _ = rr[0]["shape"]
    nbytes, shard = rows * halo * esize, rows * s_local * esize
    push_bound = (nbytes / PEAK_NVLINK if cards >= n
                  else 2 * nbytes / PEAK_HBM)
    fill_bound = 2 * shard / PEAK_HBM
    extra = {k: med(k) for k in rr[0]["ms"] if k != "K6"}
    extra.update(push_bound_ms=push_bound * 1e3,
                 fill_bound_ms=fill_bound * 1e3,
                 fills=sum(a["launches"]["K6_fill"] for a in rr),
                 ms_is="events around one exchange (push + fill), the card "
                       "kept busy, one rank at a time; medians over the "
                       "ranks that send data",
                 library_is="copy_ of the halo into the peer slot (the "
                            "push's function), the card kept busy")
    return [("K6 ring halo exchange (peer stores by CUDA IPC into the "
             "overlap-save FFT input: push + fill)",
             "ring.cu", "radar_tpu/parallel/pallas_ring.py:80",
             sum(a["launches"]["K6"] for a in rr),
             max(a["halo_max_abs_err"] for a in rr), med("K6"),
             med("plain_os_input"), (push_bound + fill_bound) * 1e3, "bytes",
             med("library_copy"), extra)]


TRACK_FRAMES = 50        # the five-target headline's frames a run
TRACK_SEEDS = (0, 1, 2)


def _tracked_run(fn, frames: int, syncs: bool = True,
                 profile: bool = False) -> tuple:
    """(fn's result, stats) of one multi-frame run: frames/s by the host
    clock and CUDA events' ms a frame around the run (which ends on the
    host); with ``syncs``, the host syncs a frame (warnings of
    ``torch.cuda.set_sync_debug_mode``, whose hooks ride in the timed
    run); with ``profile``, the device busy ms and idle share of the run
    by torch.profiler (its overhead rides in the wall)."""
    import contextlib
    import warnings

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught, (
            tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            if profile else contextlib.nullcontext()) as prof:
        warnings.simplefilter("always")
        if syncs:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            a.record()
            t0 = time.perf_counter()
            out = fn()
            b.record()
            b.synchronize()
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
    stats = {"frames_per_s": round(frames / wall, 3),
             "event_ms_a_frame": round(a.elapsed_time(b) / frames, 4)}
    if syncs:
        stats["host_syncs_a_frame"] = round(sum(
            "synchroniz" in str(w.message) for w in caught) / frames, 3)
    if prof is not None:
        dev_t = lambda e: getattr(e, "self_device_time_total",
                                  getattr(e, "self_cuda_time_total", 0))
        busy = sum(dev_t(e) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1000.0
        stats["device_busy_ms"] = round(busy, 3)
        stats["wall_ms"] = round(wall * 1e3, 3)
        stats["idle_share"] = round(1.0 - busy / (wall * 1e3), 4)
    return out, stats


def _same_log(a, b) -> bool:
    """Whether two detection logs are equal bit for bit."""
    return len(a) == len(b) and all(
        np.array_equal(getattr(a, f), getattr(b, f)) for f in (
            "range_m", "velocity_ms", "elevation_deg", "power", "frame",
            "azimuth_deg"))


def _tracking(cfg, pre, ref_cfg, ref_pre, dev, card, counts, reset) -> dict:
    """Phase ``tracking``: the device-scan runner (``pipeline/driver.py::
    run_multiframe_device``) at full width on the five-target headline
    (perf config, simple kinematics, 50 frames x 3 seeds: 5/5 clean tracks
    a seed, at most one false track in all), its chunked resume through a
    store, the two-target altitude scene against the host loop, 10 frames
    of the exact stream, the tracking Monte-Carlo's entry point (6 scenes
    x 40 frames) and the smoother on the headline's tracks; each run's
    kernel counts, frames/s, event ms and host syncs a frame. Prints a
    line per run, raises on any failed hold, returns the launches a run
    for the kernels line."""
    import shutil

    from radar_tpu_torch.io.orbax_store import OrbaxFrameStore
    from radar_tpu_torch.pipeline.driver import (associate_tracks,
                                                 device_results_to_log,
                                                 make_device_multiframe,
                                                 run_multiframe,
                                                 run_multiframe_device)
    from radar_tpu_torch.pipeline.track_metrics import (score_tracks,
                                                        truth_trajectories)
    from radar_tpu_torch.pipeline.tracking import smooth_tracks
    from radar_tpu_torch.scripts import run_tracking_mc
    from radar_tpu_torch.sim.scenario import (default_two_target_scene,
                                              five_target_scene)

    scene = five_target_scene()
    headline = lambda seed, frames=TRACK_FRAMES, c=cfg, p=pre, **kw: \
        run_multiframe_device(c, scene, frames, seed=seed, precomp=p,
                              kinematics="simple", device=dev, **kw)
    # the runner built once (the tracking MC's way): its build apart
    build_ms = statistics.median(_host_ms(lambda: make_device_multiframe(
        cfg, pre, "simple", device=dev)) for _ in range(3))
    runner = make_device_multiframe(cfg, pre, "simple", device=dev)

    def built(seed):
        res, az, _ = runner(seed, scene, TRACK_FRAMES)
        log = device_results_to_log(res, az)
        return log, associate_tracks(log, cfg)

    _line("tracking", run="make_device_multiframe build", card=repr(card),
          host_ms=round(build_ms, 3))
    launches = {}
    false_total, first = 0, None
    for seed in TRACK_SEEDS:
        # seeds 0 and 2 through run_multiframe_device (its processor built
        # in the run; 0 counts host syncs, 2 runs under the profiler), 1
        # on the built runner with no hooks
        reset()
        (log, tracks), stats = _tracked_run(
            (lambda: built(seed)) if seed == 1 else (lambda: headline(seed)),
            TRACK_FRAMES, syncs=seed == 0, profile=seed == 2)
        got = counts()
        sc = score_tracks(log, tracks, scene, TRACK_FRAMES, cfg,
                          kinematics="simple")
        false_total += sc.false_tracks
        first = first or (log, tracks)
        _line("tracking", run=f"headline seed {seed}", card=repr(card),
              entry="runner built once" if seed == 1
              else "run_multiframe_device",
              frames=TRACK_FRAMES, launches=got, detections=len(log),
              tracks=len(tracks), track_pd=sc.track_pd,
              matched_tracks=int(sc.truth_n_tracks.sum()),
              fragmentation=sc.fragmentation, false_tracks=sc.false_tracks,
              ghost_tracks=sc.ghost_tracks,
              switched_tracks=sc.switched_tracks,
              coverage=np.round(sc.truth_coverage, 3).tolist(), **stats)
        _require(got["K1"] == TRACK_FRAMES and got["K2"] == TRACK_FRAMES,
                 f"headline seed {seed}: K1 and K2 at {TRACK_FRAMES}")
        _require(sc.track_pd == 1.0 and int(sc.truth_n_tracks.sum()) == 5
                 and sc.fragmentation == 1.0,
                 f"headline seed {seed}: 5 matched tracks, one a truth")
        launches["headline"] = got
    _require(false_total <= 1, f"headline: {false_total} false tracks in "
             f"{len(TRACK_SEEDS)} seeds (at most 1)")
    log0, tracks0 = first
    assoc_ms = statistics.median(
        _host_ms(lambda: associate_tracks(log0, cfg)) for _ in range(20))
    _line("tracking", run="association", rows=len(log0),
          host_ms=round(assoc_ms, 4), engine="native (csrc/tracker.cpp)")

    # the smoother on the headline's tracks, each held to its truth
    smoothed = smooth_tracks(log0, tracks0, cfg)
    traj = truth_trajectories(scene, TRACK_FRAMES, cfg, "simple")["range_m"]
    rows = []
    for st in smoothed:
        tr = traj[:, st.frames - 1]
        k = int(np.argmin(np.abs(st.meas_range_m[None] - tr).mean(1)))
        rmse = lambda x: float(np.sqrt(np.mean((x - tr[k]) ** 2)))
        rows.append([k, len(st.frames), round(rmse(st.meas_range_m), 3),
                     round(rmse(st.range_m), 3),
                     round(float(st.innovation_nis.mean()), 3)])
    _line("tracking", run="smooth_tracks",
          truth_frames_rmse_meas_smoothed_mean_nis=rows)
    _require(len(smoothed) >= 5 and all(
        np.all(np.isfinite(st.range_m)) and np.all(np.isfinite(
            st.velocity_std_ms)) for st in smoothed),
        "smooth_tracks: 5 or more finite smoothed tracks")

    # chunked resume in one process: stop after 8 of 12 frames, resume
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_store")
    shutil.rmtree(root, ignore_errors=True)
    whole, _ = headline(7, 12)
    reset()
    _, st_a = _tracked_run(lambda: headline(
        7, 8, store=OrbaxFrameStore(root), chunk_frames=4), 8)
    part = counts()
    reset()
    (resumed, _), st_b = _tracked_run(lambda: headline(
        7, 12, store=OrbaxFrameStore(root), chunk_frames=4), 4)
    rest = counts()
    same = _same_log(resumed, whole)
    _line("tracking", run="chunked resume (12 frames, chunks of 4)",
          launches_first_8=part, launches_resumed=rest,
          chunks_done=OrbaxFrameStore(root).frames_done(),
          log_rows=len(whole), bit_identical=same, first_8=st_a,
          resumed_4=st_b)
    _require(same and part["K1"] == 8 and rest["K1"] == 4,
             "chunked resume: the unchunked log bit for bit, 8 + 4 frames")
    shutil.rmtree(root, ignore_errors=True)

    # the two-target altitude scene: device scan against the host loop
    two = default_two_target_scene()
    reset()
    (log_d, tracks_d), st_d = _tracked_run(lambda: run_multiframe_device(
        cfg, two, 10, seed=3, precomp=pre, device=dev), 10)
    launches["altitude_scan"] = counts()
    (log_h, tracks_h, _), st_h = _tracked_run(lambda: run_multiframe(
        cfg, two, 10, seed=3, precomp=pre, device=dev), 10)
    close = (len(log_d) == len(log_h) and np.array_equal(log_d.frame,
                                                         log_h.frame)
             and np.allclose(log_d.range_m, log_h.range_m, rtol=0, atol=1.0)
             and np.allclose(log_d.velocity_ms, log_h.velocity_ms, rtol=0,
                             atol=0.5)
             and np.allclose(log_d.azimuth_deg, log_h.azimuth_deg, rtol=0,
                             atol=1e-3) and len(tracks_d) == len(tracks_h))
    _line("tracking", run="altitude scene, device scan vs host loop",
          rows=[len(log_d), len(log_h)], tracks=[len(tracks_d),
                                                 len(tracks_h)],
          max_range_diff=float(np.max(np.abs(log_d.range_m - log_h.range_m))
                               ) if len(log_d) == len(log_h) else None,
          within_jax_tolerances=close, launches=launches["altitude_scan"],
          scan=st_d, host_loop=st_h)
    _require(close and len(log_d) >= 10, "altitude scene: the device scan "
             "within JAX's tolerances of the host loop")

    # the exact stream (--exact): K3 each frame
    reset()
    (log_x, tracks_x), st_x = _tracked_run(
        lambda: headline(0, 10, ref_cfg, ref_pre), 10)
    launches["exact"] = counts()
    sc_x = score_tracks(log_x, tracks_x, scene, 10, ref_cfg, "simple")
    _line("tracking", run="exact stream, 10 frames", launches=
          launches["exact"], detections=len(log_x), tracks=len(tracks_x),
          track_pd=sc_x.track_pd, false_tracks=sc_x.false_tracks, **st_x)
    _require(launches["exact"]["K3"] == 10, "exact stream: K3 at 10")

    # the tracking Monte-Carlo's entry point, 2 scenes of each type
    out = os.path.join(os.path.dirname(root), "tracking_mc_smoke.json")
    reset()
    _, st_m = _tracked_run(lambda: run_tracking_mc.main(
        ["--scenes", "6", "--frames", "40", "--out", out]), 240)
    launches["mc"] = counts()
    with open(out) as f:
        mc = json.load(f)
    tpu_path = os.path.join(os.path.dirname(root), os.pardir, "results",
                            "tracking_mc.json")
    with open(tpu_path) as f:
        tpu = json.load(f)
    _line("tracking", run="tracking MC 6 x 40", launches=launches["mc"],
          device=repr(mc["device"]), overall=mc["overall"],
          by_scene_type=mc["by_scene_type"], wall_s=mc["wall_s"],
          beside=f"results/tracking_mc.json ({tpu['device']}, "
                 f"{tpu['scenes']} scenes): {tpu['overall']}", **st_m)
    _require(launches["mc"]["K1"] == 240 and launches["mc"]["K2"] == 240,
             "tracking MC: K1 and K2 at 240")
    _require(mc["overall"]["track_pd"] >= 0.95
             and mc["overall"]["switched_tracks_total"] == 0,
             "tracking MC: mean track Pd >= 0.95, no switched track")
    return {"K1": TRACK_FRAMES, "K2": TRACK_FRAMES,
            "K3": launches["exact"]["K3"]}


REALDATA_TRUTH = (1500, 12.0, 12.0)     # gate, m/s, physical elevation
REALDATA_AMP = 1.0       # per-sample echo amplitude on unit-power noise


def _realdata_frames(cfg, dev):
    """Two consecutive gated frames [2P, 3404, 16] complex64 on the card:
    unit-power noise and one echo coherent across both (the long
    segment's pulse at the truth gate, the real-data DBF's conjugate
    steering; tests/test_realdata.py's scene)."""
    import torch

    from radar_tpu_torch.pipeline.stages import _segment_pulses

    sig = cfg.sig
    n_p, n_g, n_c = sig.prt_num, sig.n_total_gate, sig.channel_num
    gate, vel, el = REALDATA_TRUTH
    _, _, p3 = _segment_pulses(cfg)
    dphi = 2 * np.pi * 0.0138 * np.sin(np.deg2rad(el)) / sig.wavelength
    steer = np.exp(-1j * np.arange(n_c) * dphi)
    dop = np.exp(1j * 2 * np.pi * (2 * vel / sig.wavelength)
                 * np.arange(2 * n_p) * sig.prt)
    seg = np.zeros(n_g, complex)
    seg[gate:gate + len(p3)] = p3
    c = lambda a: torch.as_tensor(a.astype(np.complex64), device=dev)
    gen = torch.Generator(dev).manual_seed(20261018)
    two = torch.randn((2 * n_p, n_g, n_c), dtype=torch.complex64,
                      device=dev, generator=gen)
    return two + REALDATA_AMP * (c(dop)[:, None, None] * c(seg)[None, :, None]
                                 * c(steer)[None, None, :])


def _strongest(meas, dets) -> tuple:
    """(gate, Doppler bin, pair, range m, velocity m/s, elevation deg) of
    the strongest valid measurement."""
    v = meas.valid.cpu().numpy()
    if not v.any():
        return None
    i = int(np.flatnonzero(v)[np.argmax(meas.power.cpu().numpy()[v])])
    return (int(dets.r_idx[i]), int(dets.v_idx[i]), int(dets.pair_idx[i]),
            round(float(meas.range_m[i]), 3),
            round(float(meas.velocity_ms[i]), 4),
            round(float(meas.elevation_deg[i]), 4))


def _realdata(card: str, counts, reset, dev) -> dict:
    """Phase ``realdata``: the second detector family at full width. A
    .bin frame pair (2 x 332 PRT records of 3404 gates x 16 channels) with
    the injected target is written by the native writer, read back onto
    the card by the native reader (and by the numpy reader, bit for bit
    alike), then ``run_realdata_pipeline`` (stages 1-4) and
    ``run_realdata_pipeline_windowed`` (the 664-pulse PC, four slices)
    run on it; the target is required within 3 gates and 2 Doppler bins in
    every run, and the card's RDM within 1e-5 RMS-relative of the port's
    CPU run of the same frame. Times: the frame and the windowed chain by
    CUDA events, host syncs a frame, the idle share by the profiler, each
    stage on a busy card, the .bin write and reads on the host clock. No
    kernel of the table runs here: the counters stay at 0."""
    import torch

    from radar_tpu_torch.config import assets
    from radar_tpu_torch.config.params import RadarConfig
    from radar_tpu_torch.io import binio
    from radar_tpu_torch.ops.dbf import dbf
    from radar_tpu_torch.pipeline import stages

    cfg = RadarConfig()
    sig = cfg.sig
    n_p = sig.prt_num
    t_all = time.perf_counter()
    iq = _realdata_frames(cfg, dev).cpu().numpy()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_realdata")
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "frames.bin")
    try:
        # freq_no in the header is MATLAB's 1-based frequency point
        write_ms = _host_ms(lambda: binio.write_bin(
            path, iq, 0.0, freq_no=7, fs_hz=sig.fs, prt_s=sig.prt))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames, meta, servo = binio.read_bin_frames(path, n_p, device=dev)
        torch.cuda.synchronize()
        read_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        frames_np, _, _ = binio.read_bin_frames(path, n_p, use_native=False,
                                                device=dev)
        torch.cuda.synchronize()
        read_np_ms = (time.perf_counter() - t0) * 1e3
        file_mb = os.path.getsize(path) / 1e6
    finally:
        if os.path.exists(path):
            os.remove(path)
    scale = binio.default_iq_scale(iq)
    q_err = float((frames.reshape(iq.shape).cpu()
                   - torch.from_numpy(iq)).abs().max())
    _line("realdata", file_mb=round(file_mb, 3), records=meta.n_prt,
          shape=list(frames.shape), device=str(frames.device),
          write_native_host_ms=round(write_ms, 2),
          read_native_host_ms=round(read_ms, 2),
          read_numpy_host_ms=round(read_np_ms, 2),
          readers_identical=bool(torch.equal(frames, frames_np)),
          quantization_max_err=q_err, iq_scale=scale, card=repr(card))
    _require(frames.device.type == dev.type and meta.n_prt == 2 * n_p
             and meta.freq_no == 7, "read_bin_frames: 664 records on the card")
    _require(bool(torch.equal(frames, frames_np)),
             "the native and numpy readers agree bit for bit")
    _require(q_err <= 0.51 * scale * np.sqrt(2.0),
             "int16 round trip within half a quantization step")
    del frames_np
    freq_no = meta.freq_no - 1
    f0, f1 = frames[0], frames[1]

    gate, vel, _ = REALDATA_TRUTH
    v_axis = np.linspace(-sig.v_max / 2, sig.v_max / 2, n_p)
    v_bin = int(np.argmin(np.abs(v_axis - vel)))

    def on_truth(hit) -> bool:
        if hit is None:
            return False
        dv = abs(hit[1] - v_bin)
        return abs(hit[0] - gate) <= 3 and min(dv, n_p - dv) <= 2

    run = lambda: stages.run_realdata_pipeline(f0, cfg, freq_no)
    run()
    torch.cuda.synchronize()
    reset()
    meas, dets, rdm = run()
    torch.cuda.synchronize()
    launches = counts()
    hit = _strongest(meas, dets)
    n_det = int(dets.count)
    reset()
    meas_w, rdm_w = stages.run_realdata_pipeline_windowed(f0, f1, cfg,
                                                          freq_no)
    torch.cuda.synchronize()
    launches_w = counts()
    dets_w = [stages.stage3_detection(rdm_w[k], cfg)[0] for k in range(4)]
    hits_w = [_strongest(m, d) for m, d in zip(meas_w, dets_w)]
    slice0_vs_single = _rel_rms(rdm_w[0], rdm)

    # the port's CPU run of the same frame
    t0 = time.perf_counter()
    meas_c, dets_c, rdm_c = stages.run_realdata_pipeline(f0.cpu(), cfg,
                                                         freq_no)
    cpu_s = time.perf_counter() - t0
    card_vs_cpu = _rel_rms(rdm.cpu(), rdm_c)
    hit_c = _strongest(meas_c, dets_c)
    _line("realdata", run="run_realdata_pipeline", shape=list(f0.shape),
          rdm=list(rdm.shape), launches=launches, detections=n_det,
          strongest=hit, truth=(gate, v_bin, vel), card_vs_cpu_rms=card_vs_cpu,
          cpu_detections=int(dets_c.count), cpu_strongest=hit_c,
          cpu_run_s=round(cpu_s, 2), tol="target within 3 gates and 2 "
          "bins; RDM card vs CPU rms(err) <= 1e-5 rms")
    _line("realdata", run="run_realdata_pipeline_windowed",
          rdm_slices=list(rdm_w.shape), launches=launches_w,
          strongest=hits_w, slice0_vs_single_rms=slice0_vs_single,
          detections=[int(d.count) for d in dets_w])
    _require(on_truth(hit), f"realdata frame: target found ({hit})")
    _require(all(on_truth(h) for h in hits_w),
             f"realdata windowed: target in every slice ({hits_w})")
    _require(card_vs_cpu <= 1e-5, "realdata RDM: card vs CPU 1e-5")
    _require(slice0_vs_single <= 1e-5, "windowed slice 0 == the frame")
    _require(hit_c is not None and hit_c[:3] == hit[:3],
             "the CPU run finds the same strongest cell")
    _require(all(v == 0 for v in list(launches.values())
                 + list(launches_w.values())),
             "the real-data path reaches none of the kernel table's rows")

    # times: the frame and the windowed chain end on the host (a read of
    # the valid count), 10 and 3 a run
    def frames_run(n, windowed=False):
        for _ in range(n):
            out = (stages.run_realdata_pipeline_windowed(f0, f1, cfg,
                                                         freq_no)[0][-1]
                   if windowed else run()[0])
        return int(out.valid.sum())

    _, st = _tracked_run(lambda: frames_run(10), 10)
    _, stp = _tracked_run(lambda: frames_run(10), 10, syncs=False,
                          profile=True)
    frames_run(1, True)
    _, sw = _tracked_run(lambda: frames_run(3, True), 3)
    _, swp = _tracked_run(lambda: frames_run(3, True), 3, syncs=False,
                          profile=True)
    dbf_w = np.asarray(assets.dbf_coeffs())
    beams = dbf(f0, dbf_w, "realdata")
    rdm2, _ = stages.stage2_mtd(beams, cfg)
    maps = stages.pair_sum_maps_realdata(rdm2)
    d3, _ = stages.stage3_detection(rdm2, cfg, maps=maps)
    consts = stages.measure_consts(cfg, freq_no, device=dev)
    stage_ms = {name: round(_busy_event_ms(fn, 5)[0], 4) for name, fn in (
        ("dbf", lambda: dbf(f0, dbf_w, "realdata")),
        ("stage2_pc_mtd", lambda: stages.stage2_mtd(beams, cfg)),
        ("pair_maps", lambda: stages.pair_sum_maps_realdata(rdm2)),
        ("stage3_cfar_extract",
         lambda: stages.stage3_detection(rdm2, cfg, maps=maps)),
        ("stage4_measure", lambda: stages.stage4_measurement(
            d3, rdm2, cfg, freq_no, maps=maps, consts=consts)))}
    _line("realdata", card=repr(card), frame=st, frame_profiled=stp,
          windowed=sw, windowed_profiled=swp, busy_card_stage_ms=stage_ms,
          phase_s=round(time.perf_counter() - t_all, 2))
    return {"frame": st, "frame_profiled": stp, "windowed": sw,
            "windowed_profiled": swp, "stage_ms": stage_ms}


def _doa(card: str, dev) -> dict:
    """Phase ``doa``: the DoA tools on the card at BASELINE config 4's
    128 elements: ``music_1d`` (128-element ULA, 512 snapshots drawn by
    ``simulate_snapshots`` on the card, complex128; its spectrum held to the
    port's CPU run at rtol 1e-5), root-MUSIC and TLS/LS-ESPRIT on the same
    snapshots, ``music_2d`` on the 16x8 URA (1-deg grid, then
    ``refine=True``) and ``esprit_2d``, each within ``tests/test_doa.py``'s
    tolerances; each method's host ms a call (it ends on the host)."""
    import torch

    from radar_tpu_torch.doa import music, superres

    wl = 2.99792458e8 / 9450e6
    d = wl / 2
    t_all = time.perf_counter()
    truth1 = np.array([-5.0, -4.0, 10.0])
    x1 = music.simulate_snapshots(torch.Generator(dev).manual_seed(2),
                                  truth1, 128, d, wl, 512, snr_db=5.0,
                                  dtype=torch.complex128, device=dev)
    scan = np.arange(-20.0, 20.0 + 1e-9, 0.05)
    m1 = music.music_1d(x1, 3, d, wl, scan)
    m1c = music.music_1d(x1.cpu(), 3, d, wl, scan)
    spec_err = float(((m1.spectrum.cpu() - m1c.spectrum).abs()
                      / m1c.spectrum.abs()).max())
    rm = superres.root_music_1d(x1, 3, d, wl)
    es = superres.esprit_1d(x1, 3, d, wl, tls=True)
    es_ls = superres.esprit_1d(x1, 3, d, wl, tls=False)

    rng = np.random.default_rng(4)

    def ura(truth, k=512, noise=0.1):
        a = music.steering_ura(truth[:, 0], truth[:, 1], 16, 8, 0.5)
        m = len(truth)
        a = np.stack([a[:, i * m + i] for i in range(m)], axis=1)
        s = (rng.normal(size=(m, k)) + 1j * rng.normal(size=(m, k))) \
            / np.sqrt(2)
        n = (rng.normal(size=(128, k)) + 1j * rng.normal(size=(128, k))) \
            * np.sqrt(0.5) * noise
        return a @ s + n

    by_az = lambda p: p[np.argsort(p[:, 0])]
    truth2 = np.array([[12.3, 25.7], [-40.6, 55.4]])
    x2 = torch.as_tensor(ura(truth2), dtype=torch.complex64, device=dev)
    az = np.arange(-60.0, 60.0 + 1e-9, 1.0)
    el = np.arange(10.0, 80.0 + 1e-9, 1.0)
    coarse = music.music_2d(x2, 2, 16, 8, 0.5, az_deg=az, el_deg=el)
    fine = music.music_2d(x2, 2, 16, 8, 0.5, az_deg=az, el_deg=el,
                          refine=True)
    truth3 = np.array([[12.34, 25.71], [12.9, 55.43], [-40.62, 40.2]])
    x3 = torch.as_tensor(ura(truth3), dtype=torch.complex128, device=dev)
    e2 = superres.esprit_2d(x3, 3, 16, 8, 0.5)
    errs = {"music_1d": float(np.abs(m1.peaks_deg - truth1).max()),
            "root_music_1d": float(np.abs(rm - truth1).max()),
            "esprit_1d_tls": float(np.abs(es - truth1).max()),
            "esprit_1d_ls": float(np.abs(es_ls - truth1).max()),
            "music_2d_grid": float(np.abs(by_az(coarse.peaks_deg)
                                          - by_az(truth2)).max()),
            "music_2d_zoom": float(np.abs(by_az(fine.peaks_deg)
                                          - by_az(truth2)).max()),
            "esprit_2d": float(np.abs(e2 - by_az(truth3)).max())}
    tol = {"music_1d": 0.2, "root_music_1d": 0.1, "esprit_1d_tls": 0.1,
           "esprit_1d_ls": 0.1, "music_2d_grid": 0.5 + 1e-6,
           "music_2d_zoom": 0.15, "esprit_2d": 0.15}

    def host_ms(fn, reps=5):
        fn()
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            out.append(_host_ms(fn))
        return round(statistics.median(out), 3)

    ms = {"music_1d (c128, 801 angles)": host_ms(
              lambda: music.music_1d(x1, 3, d, wl, scan)),
          "root_music_1d": host_ms(
              lambda: superres.root_music_1d(x1, 3, d, wl)),
          "esprit_1d_tls": host_ms(lambda: superres.esprit_1d(x1, 3, d, wl)),
          "music_2d (c64, 121x71 grid)": host_ms(lambda: music.music_2d(
              x2, 2, 16, 8, 0.5, az_deg=az, el_deg=el)),
          "music_2d refine": host_ms(lambda: music.music_2d(
              x2, 2, 16, 8, 0.5, az_deg=az, el_deg=el, refine=True)),
          "esprit_2d (c128)": host_ms(
              lambda: superres.esprit_2d(x3, 3, 16, 8, 0.5)),
          "steering_ura of the 121x71 grid (host numpy, in music_2d)":
              host_ms(lambda: music.steering_ura(az, el, 16, 8, 0.5))}
    _line("doa", elements=128, snapshots=512, device=str(x1.device),
          max_abs_err_deg=errs, tol_deg=tol, music_1d_spectrum_card_vs_cpu=
          spec_err, peaks_card_equal_cpu=bool(np.array_equal(
              m1.peaks_deg, m1c.peaks_deg)), host_ms_a_call=ms,
          card=repr(card), phase_s=round(time.perf_counter() - t_all, 2))
    _require(all(errs[k] <= tol[k] for k in tol),
             f"doa: every method within its tolerance ({errs})")
    _require(spec_err <= 1e-5, "doa: MUSIC spectrum card vs CPU rtol 1e-5")
    _require(np.array_equal(m1.peaks_deg, m1c.peaks_deg),
             "doa: MUSIC peaks card == CPU")
    return {"errs": errs, "ms": ms}


def _new_scripts(card: str, dev) -> dict:
    """The real-data and DoA paths' entry points, through their ``main``:
    the ROC script at its default counts (200 trials, 400 noise frames)
    and the DoA accuracy study at 10 trials, each on the card, JSON into
    build/."""
    from radar_tpu_torch.scripts import run_doa_accuracy, run_roc_realdata

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    on = [] if dev.type == "cuda" else ["--cpu"]
    t0 = time.perf_counter()
    roc = run_roc_realdata.main(on + ["--out", os.path.join(
        root, "roc_realdata_smoke.json")])
    roc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    doa = run_doa_accuracy.main(on + ["--trials", "10", "--out", os.path.join(
        root, "doa_accuracy_smoke.json")])
    doa_s = time.perf_counter() - t0
    i8 = roc["t_factors"].index(8.0)
    _line("scripts", roc_realdata_wall_s=round(roc_s, 2),
          roc_trials=roc["trials_per_t"], roc_noise_frames=roc["noise_frames"],
          roc_pd_at_8=roc["pd"][i8], roc_pfa_hits_at_8=roc["pfa_hits"][i8],
          roc_arms_s=roc["wall_s"], doa_accuracy_wall_s=round(doa_s, 2),
          doa_rmse_1d=doa["1d_ula"]["rmse_deg"],
          doa_rmse_2d=doa["2d_ura_16x8"]["rmse_deg"], card=repr(card))
    _require(roc["device"].startswith(card.split(" (")[0])
             and doa["device"].startswith(card.split(" (")[0]),
             "the scripts ran on the card")
    _require(roc["pd"][0] >= 0.95 and roc["pd"] == sorted(roc["pd"],
                                                         reverse=True),
             "ROC: Pd falls with T from ~1")
    _require(all(v < 0.1 for k, v in doa["1d_ula"]["rmse_deg"].items()
                 if k != "music_grid")
             and doa["2d_ura_16x8"]["rmse_deg"]["esprit_2d"] < 0.1,
             "DoA accuracy: the search-free methods below 0.1 deg")
    return {"roc_s": roc_s, "doa_s": doa_s}


def _host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing runs on the CPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    from radar_tpu_torch import _build, native
    from radar_tpu_torch.config.params import (PERF_OVERRIDES, full_config,
                                               perf_config,
                                               small_test_config)
    from radar_tpu_torch.ops import awgn as k5
    from radar_tpu_torch.ops import cfar_kernel as ck
    from radar_tpu_torch.ops import noise_rdm as nr
    from radar_tpu_torch.pipeline.driver import run_multiframe
    from radar_tpu_torch.pipeline.frame import make_frame_processor
    from radar_tpu_torch.pipeline.lowrank import make_lowrank_stages
    from radar_tpu_torch.pipeline.montecarlo import make_trial_fn, snr_sweep
    from radar_tpu_torch.pipeline.streaming import run_streaming_mc
    from radar_tpu_torch.sim.scenario import (TargetBatch,
                                              default_two_target_scene)
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
    _build.build_all(["noise_rdm", "noise_rdm_sm90", "rdm_variants",
                      "band_pc_sm90", "rdm_sm90", "cfar", "awgn", "ring"])
    _line("build", torch=torch.__version__, cuda=torch.version.cuda,
          seconds=round(time.perf_counter() - t0, 2))
    t0 = time.perf_counter()
    native.load_library()       # the host C++ track associator
    _line("build", tracker="csrc/tracker.cpp",
          seconds=round(time.perf_counter() - t0, 2))
    for name, info in _build.build_info.items():
        for ln in info["log"].splitlines():
            if "Used" in ln or "spill" in ln or "wgmma" in ln:
                print(f"  ptxas {name}: {ln.strip()}", flush=True)
    # what the redesigned kernels compiled to: wgmma (HGMMA) in the bf16
    # DFT GEMM (K10's, K7's and K9's) and K4's PC (its instances), TMA loads
    # (UTMALDG) in every K3 instance
    sass = {f"{k} {op}": _sass_has(_build._library_path(lib)[1], k, op)
            for lib, k, op in (("rdm_sm90", "dft_kernel", "HGMMA"),
                               ("noise_rdm_sm90", "k4_pc_kernel", "HGMMA"),
                               ("noise_rdm_sm90", "k8_pc_kernel", "HGMMA"),
                               ("band_pc_sm90", "strip_pc_kernel", "HGMMA"),
                               ("cfar", "k3_kernel", "UTMALDG"))}
    _line("sass", functions_holding_opcode=sass)
    _require(all(v and all(v) for v in sass.values()),
             "HGMMA in the DFT GEMM, K4's and K8's PC and both strip GEMMs, "
             "UTMALDG in K3")

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
    counts = lambda: {"K1": nr.launch_count, "K2": ck.launch_count,
                      "K3": ck.k3_launch_count, "K5": k5.launch_count,
                      "K1c": nr.k1c_launch_count, "K4": nr.k4_launch_count,
                      "K1_maps": nr.maps_launch_count}

    def reset():
        nr.launch_count = ck.launch_count = 0
        ck.k3_launch_count = k5.launch_count = 0
        nr.k1c_launch_count = nr.k4_launch_count = 0
        nr.maps_launch_count = 0

    reset()
    res = process(20261016, truth)
    torch.cuda.synchronize()
    launches = counts()
    rows = _rows(res)
    dr = float(pre.delta_r)
    dv = float(pre.velocity_axis[1] - pre.velocity_axis[0])
    found = _found(rows, truth, dr, dv)
    _line("frame", launches=launches, num_raw=int(res.num_raw_detections),
          num_final=int(res.num_final), found=found,
          targets=np.round(rows, 3).tolist())
    _require(launches["K1"] >= 1 and launches["K2"] >= 1,
             "frame launched K1 and K2")
    _require(bool(np.all(np.isfinite(rows))) and all(found),
             "truth targets found")
    # the frame's kernels by name: K1's GEMMs, mix and K1c's planes, K2;
    # the CUDA-core convolution of the old K1 no longer runs
    frame_kernels = _kernel_ms(lambda: process(20261016, truth), reps=2)
    names = {k: round(v, 4) for k, v in frame_kernels.items()
             if any(n in k for n in ("gemm_kernel", "mix_planes",
                                     "planes_kernel", "k2_kernel",
                                     "pc_kernel"))}
    _line("frame_kernels", kernels=names)
    _require(all(any(n in k for k in names) for n in (
        "pc_gemm_kernel", "dft_gemm_kernel", "mix_planes_kernel",
        "planes_kernel", "k2_kernel")) and not any(
        "pc_kernel" in k for k in names),
        "the frame ran K1's GEMMs and K2, and no CUDA-core pc_kernel")

    # small widths: the kernel path on the card vs the plain path on the CPU
    small = small_test_config().replace(**PERF_OVERRIDES)
    tb2 = TargetBatch.make([3000.0, 6000.0], [15.0, -8.0], [10.0, 12.0],
                           [20.0, 14.0])
    a = make_frame_processor(small, device=dev)(5, tb2)
    b = make_frame_processor(small, device="cpu")(5, tb2)
    _line("small", card_final=int(a.num_final), cpu_final=int(b.num_final))
    _require(int(a.num_final) == int(b.num_final) >= 2,
             "card and CPU frames agree")
    _same_rows(_rows(a)[:, :2], _rows(b)[:, :2], rtol=1e-4)

    ref_cfg = full_config()
    ref_pre = precompute(ref_cfg)

    # ---- 5b. phase tails: every tail variant at full width
    tails_extra = _tails(nr, ck, cfg, pre, ref_cfg, ref_pre, truth, dr, dv,
                         dev, card, counts, reset, process)

    # ---- 7. K5 at the raw-cube shape vs its plain version, statistics
    shape = (ref_cfg.sig.prt_num, ref_cfg.sig.point_prt,
             ref_cfg.sig.channel_num)
    zeros = torch.zeros(shape, dtype=torch.complex64, device=dev)
    k5_seed = nr.seed_words(77)
    y = k5.awgn(zeros, k5_seed)
    y_p = k5.awgn_plain(zeros, k5_seed)
    torch.cuda.synchronize()
    k5_err = float((y - y_p).abs().max())
    re, im = y.real.double().reshape(-1), y.imag.double().reshape(-1)
    stats = {}
    for name, rail in (("re", re), ("im", im)):
        c = rail - rail.mean()
        var = float(rail.var())
        stats[name] = {"mean": float(rail.mean()), "var": var,
                       "kurt": float((c**4).mean()) / var**2,
                       "lag1": float((c[1:] * c[:-1]).mean()) / var}
    re_im = float((re * im).mean())
    sig = torch.full_like(zeros, 3.0 - 2.0j)
    passthrough = float((k5.awgn(sig, k5_seed) - y - sig).abs().max())
    _line("K5", shape=list(shape), max_abs_err=k5_err,
          identical=bool(torch.equal(y, y_p)), tol="max|err|<=1e-5",
          stats=stats, re_im=re_im, passthrough_err=passthrough)
    _require(k5_err <= 1e-5, "K5 vs plain")
    for st in stats.values():
        _require(abs(st["mean"]) < 5e-3 and abs(st["var"] - 0.5) < 5e-3
                 and abs(st["kurt"] - 3.0) < 5e-2 and abs(st["lag1"]) < 5e-3,
                 f"K5 rail statistics {st}")
    _require(abs(re_im) < 5e-3 and passthrough <= 1e-5,
             "K5 re*im correlation and signal pass-through")
    del y, y_p, sig, re, im

    # ---- 8. K3 at full size vs its plain version, on |RDM| of a
    # reference-stream frame: the full config's window, small_test_config's
    # (both compiled in) and the generic instantiation (a narrow window, and
    # the widest the halo takes), each method; and on the first 2 and 3
    # beams (one pair, an odd pair count) at the first three windows
    inter = make_frame_processor(ref_cfg, ref_pre, device=dev,
                                 return_intermediates=True)(11, truth)
    mag = inter.rdm.permute(2, 0, 1).abs().contiguous()    # [13, 332, 3404]
    del inter
    k3_windows = {
        "full": ref_cfg.cfar, "small": small_test_config().cfar,
        "generic": dataclasses.replace(ref_cfg.cfar, guard_cells_r=2,
                                       ref_cells_r=3, guard_cells_v=1,
                                       ref_cells_v=2),
        "widest": dataclasses.replace(ref_cfg.cfar, guard_cells_r=100,
                                      ref_cells_r=28, guard_cells_v=100,
                                      ref_cells_v=28, threshold_factor=3.0)}
    k3_checks = {}
    for wname, wparams in k3_windows.items():
        for method in ("GOCA", "SOCA", "CA"):
            p3 = dataclasses.replace(wparams, method=method)
            m3, t3 = ck.goca_cfar_2d_fused(mag, p3)
            m3_p, t3_p = ck.goca_cfar_2d_fused_plain(mag, p3)
            torch.cuda.synchronize()
            k3_checks[f"{wname}/{method}"] = {
                "instance": ck.k3_geometry(p3, mag.shape[0]).instance,
                "hits": int(m3.sum()),
                "mask_cells_differing": int((m3 != m3_p).sum()),
                "thr_max_abs_err": float((t3 - t3_p).abs().max())}
    # one pair (small_test_config's 2 beams) and an odd pair count
    for num_b3 in (2, 3):
        for wname in ("full", "small", "generic"):
            for method in ("GOCA", "SOCA", "CA"):
                p3 = dataclasses.replace(k3_windows[wname], method=method)
                m3, t3 = ck.goca_cfar_2d_fused(mag[:num_b3], p3)
                m3_p, t3_p = ck.goca_cfar_2d_fused_plain(mag[:num_b3], p3)
                torch.cuda.synchronize()
                k3_checks[f"B{num_b3}/{wname}/{method}"] = {
                    "instance": ck.k3_geometry(p3, num_b3).instance,
                    "hits": int(m3.sum()),
                    "mask_cells_differing": int((m3 != m3_p).sum()),
                    "thr_max_abs_err": float((t3 - t3_p).abs().max())}
    m3, t3 = ck.goca_cfar_2d_fused(mag, ref_cfg.cfar)
    torch.cuda.synchronize()
    k3_err = max(c["thr_max_abs_err"] for c in k3_checks.values())
    _line("K3", mag=list(mag.shape), checks=k3_checks,
          tol="identical mask and threshold; hits > 0 at 13 beams")
    _require(all(c["mask_cells_differing"] == 0 and c["thr_max_abs_err"]
                 == 0.0 and (c["hits"] > 0 or k.startswith("B"))
                 for k, c in k3_checks.items()),
             "K3 == plain at every window, method and beam count")
    del m3_p, t3_p

    # ---- 9. the reference stream (the default entry point), full size
    ref_frames = {}
    for label, cfg_r, want in (
            ("pallas_noise", ref_cfg.replace(noise_impl="pallas"),
             ("K5", "K3")),
            ("threefry", ref_cfg, ("K3",)),
            ("pallas_cfar", ref_cfg.replace(use_pallas_cfar=True),
             ("K2",)),
            ("bf16", ref_cfg.replace(matmul_precision="bf16"), ("K3",)),
            ("fused", ref_cfg.replace(fused_synth_dbf=True), ("K3",))):
        proc = make_frame_processor(cfg_r, ref_pre, device=dev)
        proc(1, truth)                     # warm-up outside the count
        torch.cuda.synchronize()
        reset()
        res = proc(20261016, truth)
        torch.cuda.synchronize()
        got = counts()
        rows = _rows(res)
        found = _found(rows, truth, dr, dv)
        _line("ref_frame", config=label, launches=got,
              num_raw=int(res.num_raw_detections),
              num_final=int(res.num_final), found=found,
              targets=np.round(rows, 3).tolist())
        _require(all(got[k] >= 1 for k in want), f"{label} launched {want}")
        _require(label != "threefry" or got["K5"] == 0,
                 "the threefry stream draws no K5 noise")
        _require(bool(np.all(np.isfinite(rows))) and all(found),
                 f"{label}: truth targets found")
        ref_frames[label] = (proc, got)
    ref_launches = ref_frames["pallas_noise"][1]

    # small widths: K5 + K3 on the card vs the plain versions on the CPU
    small_ref = small_test_config().replace(noise_impl="pallas")
    a = make_frame_processor(small_ref, device=dev)(5, tb2)
    b = make_frame_processor(small_ref, device="cpu")(5, tb2)
    _line("ref_small", card_final=int(a.num_final),
          cpu_final=int(b.num_final))
    _require(int(a.num_final) == int(b.num_final) >= 2,
             "reference stream: card and CPU frames agree")
    _same_rows(_rows(a), _rows(b), rtol=1e-4)

    # ---- 10. the multi-frame driver, default scene, 5 frames
    scene = default_two_target_scene()
    mf_proc = ref_frames["threefry"][0]
    reset()
    log, tracks, _ = run_multiframe(ref_cfg, scene, 5, seed=0,
                                    processor=mf_proc, device=dev)
    mf_launches = counts()
    near = lambda tr, r, v: abs(tr.range_m - r) <= 30 and \
        abs(tr.velocity_ms - v) <= 2 * dv
    good = [[t for t in tracks if near(t, r, v) and t.num_points >= 4]
            for r, v in ((3000.0, 20.0), (10000.0, 25.0))]
    _line("multiframe", frames=5, log_rows=len(log), tracks=len(tracks),
          launches=mf_launches,
          track_rows=[[round(t.range_m, 2), round(t.velocity_ms, 3),
                       t.num_points] for t in tracks])
    _require(all(good) and mf_launches["K3"] >= 5,
             "run_multiframe: a track of >= 4 points near each truth")

    # ---- 10b. phase tracking: the device-scan runner, its resume, the
    # tracking Monte-Carlo and the smoother
    track_launches = _tracking(cfg, pre, ref_cfg, ref_pre, dev, card, counts,
                               reset)

    # ---- 10c. phases realdata and doa: the second detector family from a
    # .bin frame pair, the DoA tools at 128 elements, and their scripts
    _realdata(card, counts, reset, dev)
    _doa(card, dev)
    _new_scripts(card, dev)

    # ---- 12. the validation entry point (scripts/validate_rdm_gen.py):
    # K1c's planes through K1 == K1 draw mode, K4 vs K1, moments
    lr_uni = make_lowrank_stages(cfg.replace(noise_rdm_impl="pallas"), pre,
                                 device=dev)
    lr_norm = make_lowrank_stages(cfg.replace(noise_rdm_impl="pallas",
                                              noise_dist="normal"), pre,
                                  device=dev)
    val, k1c_planes, vseed = _validate_rdm_gen(nr, lr, lr_uni, lr_norm, plan,
                                               lmat, dev, counts, reset)
    val_launches = val.pop("launches")
    _line("validate", launches=val_launches, bit_check=val["bit_check"],
          rolling_check=val["rolling_check"], var_ratio=val["var_ratio"],
          var_ratio_normal=val["var_ratio_normal"],
          moments={k: val[k] for k in ("moments_pallas_prng",
                                       "moments_pallas_uniform",
                                       "moments_pallas_normal")},
          tol="bit 0; rolling <= 2^-7 max|y|; |var ratio-1|<0.02, "
              "|mean|<1e-2")
    _require(val["bit_check"]["pass"], "K1 on K1c planes == K1 draw mode")
    _require(val["rolling_check"]["pass"], "K4 within 2^-7 max|y| of K1")
    _require(val["moments_pass"], "moments of K1 draws vs the pallas route")
    _require(all(val_launches[k] >= 1 for k in ("K1", "K1c", "K4")),
             "the validation path launched K1, K1c and K4")
    _require(val_launches["K1c"] == 1,
             "K1c: one launch for the three segments of one call")

    # K1c at full size vs its plain version, bit for bit
    ph_planes = nr.philox_planes(plan, vseed, num_b, device=dev)
    torch.cuda.synchronize()
    same = [bool(torch.equal(a, c) and torch.equal(b, d))
            for (a, b), (c, d) in zip(k1c_planes, ph_planes)]
    k1c_err = max(float((a - c).abs().max()) for (a, _), (c, _) in
                  zip(k1c_planes, ph_planes))
    _line("K1c", planes=[list(a.shape) for a, _ in k1c_planes],
          identical_per_segment=same, max_abs_err=k1c_err, tol="bit-equal")
    _require(all(same), "K1c == philox_planes bit for bit")

    # K4 at full size vs its plain version (K1's tolerances) and vs K1
    ref_noise = nr.noise_rdm_plain(plan, lmat, ph_planes)
    rms_n = float(ref_noise.abs().pow(2).mean().sqrt())
    k1_noise = nr.noise_rdm(plan, lmat, seed=vseed, layout="bvg")
    # K4: draws made in the PC's blocks; every beams_per_step gives the
    # same map, and draw mode equals planes mode on K1c's planes bit for bit
    k4, first = {}, None
    for bps in (num_b, 1, 2):
        y4 = nr.noise_rdm(plan, lmat, seed=vseed, layout="bvg",
                          rolling=False, beams_per_step=bps)
        torch.cuda.synchronize()
        d4 = (y4 - ref_noise).abs()
        first = y4 if first is None else first
        k4[bps] = {"max_abs_err": float(d4.max()),
                   "rms_err_over_rms": float(d4.pow(2).mean().sqrt()) / rms_n,
                   "vs_K1_over_max": float((y4 - k1_noise).abs().max())
                   / float(k1_noise.abs().max()),
                   "identical_to_first": bool(torch.equal(y4, first))}
        _require(k4[bps]["rms_err_over_rms"] <= 1e-5, f"K4({bps}) rms error")
        _require(bool((d4 <= 1e-4 * rms_n + 1e-5 * ref_noise.abs()).all()),
                 f"K4({bps}) element error")
        _require(k4[bps]["vs_K1_over_max"] <= 2.0 ** -7, f"K4({bps}) vs K1")
        _require(k4[bps]["identical_to_first"],
                 f"K4({bps}) == K4({num_b}) bit for bit")
    before = nr.k4_pc_launch_count
    y4p = nr.noise_rdm(plan, lmat, planes=k1c_planes, layout="bvg",
                       rolling=False, beams_per_step=num_b)
    torch.cuda.synchronize()
    k4_planes_same = bool(torch.equal(y4p, first))
    _line("K4", beams_per_step=k4, planes_mode_identical=k4_planes_same,
          pc_launches=nr.k4_pc_launch_count - before,
          tol="rms(err)<=1e-5*rms, |err|<=1e-4*rms+1e-5*|ref|; "
              "vs K1 <= 2^-7 max|y|; draws == K1c planes, every "
              "beams_per_step: bit for bit")
    _require(k4_planes_same and nr.k4_pc_launch_count - before == 1,
             "K4 draw mode == K4 planes mode on K1c's planes, one PC launch")
    k4_err = k4[num_b]["max_abs_err"]
    del ph_planes, k1c_planes, ref_noise, k1_noise, y4, d4, y4p, first

    # ---- 13. the rank-K stream's three routes at full size
    route_cfgs = {"pallas_prng": cfg,
                  "pallas_uniform": cfg.replace(noise_rdm_impl="pallas"),
                  "pallas_normal": cfg.replace(noise_rdm_impl="pallas",
                                               noise_dist="normal"),
                  "xla": perf_config(pallas=False)}
    for label, cfg_l in route_cfgs.items():
        proc = make_frame_processor(cfg_l, pre, device=dev)
        proc(1, truth)                     # warm-up outside the count
        torch.cuda.synchronize()
        reset()
        res = proc(20261016, truth)
        torch.cuda.synchronize()
        got = counts()
        rows = _rows(res)
        found = _found(rows, truth, dr, dv)
        _line("route", noise_rdm_impl=label, launches=got,
              num_final=int(res.num_final), found=found,
              targets=np.round(rows, 3).tolist())
        _require(bool(np.all(np.isfinite(rows))) and all(found),
                 f"{label}: truth targets found")
        _require(got["K2"] >= 1 and (got["K1"] == 0 if label == "xla"
                                     else got["K1"] >= 1),
                 f"{label}: K1 launched on the kernel routes only")

    # small widths: each route on the card vs the CPU on the same noise
    small32 = small_test_config().replace(
        **{**PERF_OVERRIDES, "matmul_precision": "f32"})
    for label, over in (("pallas_prng", {}),
                        ("pallas_uniform", {"noise_rdm_impl": "pallas"}),
                        ("pallas_normal", {"noise_rdm_impl": "pallas",
                                           "noise_dist": "normal"}),
                        ("xla", {"noise_rdm_impl": "xla",
                                 "noise_dist": "normal"})):
        cfg_s = small32.replace(**over)
        cpu = make_frame_processor(cfg_s, device="cpu")
        on_card = make_frame_processor(cfg_s, device=dev)
        st_c = cpu.stages
        if label == "xla":
            z = st_c.gen_noise(5)
            a, b = on_card(0, tb2, noise=z.to(dev)), cpu(0, tb2, noise=z)
        else:
            pl_c = (st_c.noise_planes(5) if st_c.noise_planes is not None
                    else nr.gen_noise_planes(st_c.rplan, (5, 0),
                                             st_c.l_factor.shape[0],
                                             device="cpu"))
            pl_d = [(x.to(dev), y.to(dev)) for x, y in pl_c]
            a = on_card(0, tb2, noise_planes=pl_d)
            b = cpu(0, tb2, noise_planes=pl_c)
        _line("route_small", noise_rdm_impl=label,
              card_final=int(a.num_final), cpu_final=int(b.num_final))
        _require(int(a.num_final) == int(b.num_final) >= 2,
                 f"{label}: card and CPU frames agree")
        _same_rows(_rows(a), _rows(b), rtol=1e-4)

    # ---- 14. the SNR sweep (perf config, then one point each of the
    # reference stream and the xla route)
    snrs = [-10.0, 0.0, 10.0, 20.0, 30.0]
    sweeps = {}
    for label, cfg_m, pre_m, vec, n_tr, want in (
            ("perf", cfg, pre, snrs, 16, {"K1": 80, "K2": 80}),
            ("reference", ref_cfg, ref_pre, [10.0], 8, {"K3": 8}),
            ("xla", perf_config(pallas=False), pre, [10.0], 8, {"K2": 8})):
        reset()
        t0 = time.perf_counter()
        sw = snr_sweep(cfg_m, snr_db_vector=vec, num_trials=n_tr,
                       precomp=pre_m, device=dev)
        wall = time.perf_counter() - t0
        got = counts()
        sweeps[label] = got
        _line("snr_sweep", config=label, launches=got, trials=n_tr,
              snr_db=vec, pd=sw.detection_probability.tolist(),
              sigma_deg=sw.angle_error_std.tolist(),
              theory_deg=sw.theory_bound.tolist(), wall_s=round(wall, 3))
        _require(all(got[k] >= n for k, n in want.items()),
                 f"{label} sweep launched {want}")
        _require(label != "xla" or got["K1"] == 0,
                 "the xla route launches no K1")
        _require(bool(np.all(sw.detection_probability == 1.0)),
                 f"{label} sweep: Pd = 1 at every point")
        _require(bool(np.all(sw.angle_error_std < sw.theory_bound)),
                 f"{label} sweep: sigma below the theory bound")

    # ---- 15. streaming Monte-Carlo, perf config, 128 injected targets
    # (8 per scene), then the statistical hold at the hold's own scene
    # density (40 targets per scene, the CLI default behind
    # results/streaming_mc_10k_perf.json): the 512-detection cap drops
    # targets of dense scenes, so the rate depends on targets per scene
    st_proc = make_frame_processor(cfg, pre, device=dev)
    st_proc(1, truth)
    reset()
    t0 = time.perf_counter()
    stats = run_streaming_mc(cfg, num_scenes=4, targets_per_scene=8,
                             trials_per_scene=4, snr_range=(-5.0, 20.0),
                             processor=st_proc, device=dev)
    st_wall = time.perf_counter() - t0
    st_launches = counts()
    dense = run_streaming_mc(cfg, num_scenes=4, targets_per_scene=40,
                             trials_per_scene=2, snr_range=(-5.0, 20.0),
                             processor=st_proc, device=dev)
    for label, s_ in (("8_per_scene", stats), ("40_per_scene", dense)):
        _line("streaming_mc", scenes=label,
              launches=st_launches if s_ is stats else "-",
              targets=s_.total_targets, detected=s_.total_detected,
              rate=s_.detection_rate,
              rate_by_snr=s_.snr_bin_rate.tolist(),
              bin_counts=s_.snr_bin_counts.tolist(),
              range_rmse_m=s_.range_rmse_m,
              velocity_rmse_ms=s_.velocity_rmse_ms)
    _require(stats.total_targets == 128 and st_launches["K1"] == 16,
             "streaming MC: 128 targets over 16 K1 frames")
    _require(stats.range_rmse_m <= 2 * 8.4, "streaming MC range RMSE")
    _require(abs(dense.detection_rate - 0.683) <= 0.13
             and dense.range_rmse_m <= 2 * 8.4,
             "streaming MC at 40 targets per scene: rate 0.683 +- 0.13, "
             "range RMSE <= 16.8 m")

    # ---- 16. the noise-RDM kernel studies: the planes kernel's schedules
    # (K10, K7, K9) and the banded-PC study (K8)
    study_rows = _rdm_variants(nr, plan, lmat, dev, card)
    study_rows += _pc_study(nr, ref_cfg, ref_pre, dev, card)

    # ---- 17. the multi-device layer on 4 ranks (K6 in range_rdma)
    study_rows += _multichip(card, truth, dr, dv)

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
    k3_ms, k3_plain_ms = _time_pair(
        lambda: ck.goca_cfar_2d_fused(mag, ref_cfg.cfar),
        lambda: ck.goca_cfar_2d_fused_plain(mag, ref_cfg.cfar))
    k3_call = lambda: ck.goca_cfar_2d_fused(mag, ref_cfg.cfar)
    k3_busy_ms, k3_host_ms = _busy_event_ms(k3_call, reps=20)
    k3_profile = _kernel_ms(k3_call, reps=10)
    _line("K3_split", card=repr(card), busy_card_ms=round(k3_busy_ms, 5),
          idle_card_ms=round(k3_ms, 5), host_ms=round(k3_host_ms, 5),
          geometry=ck.k3_geometry(ref_cfg.cfar, mag.shape[0])._asdict(),
          profile_ms=k3_profile)
    k5_ms, k5_plain_ms = _time_pair(lambda: k5.awgn(zeros, k5_seed),
                                    lambda: k5.awgn_plain(zeros, k5_seed))
    ref_proc = ref_frames["pallas_noise"][0]
    ref_ms = statistics.median(_event_ms(lambda: ref_proc(20261016, truth),
                                         5))
    mf_ms = statistics.median(_event_ms(lambda: run_multiframe(
        ref_cfg, scene, 3, processor=mf_proc, device=dev), 3)) / 3
    k1c_ms, k1c_plain_ms = _time_pair(
        lambda: nr.gen_noise_planes(plan, seed, num_b, device=dev),
        lambda: nr.philox_planes(plan, seed, num_b, device=dev))
    n_planes = sum(num_b * plan.n_pulses * sg.xlen for sg in plan.segments)
    k1c_lib_ms = statistics.median(_event_ms(
        lambda: torch.rand(2 * n_planes, device=dev), 10))
    k1c_busy_ms, k1c_host_ms = _busy_event_ms(
        lambda: nr.gen_noise_planes(plan, seed, num_b, device=dev))
    k1c_lib_busy_ms, _ = _busy_event_ms(
        lambda: torch.rand(2 * n_planes, device=dev))
    # K1c's operations: the SM clocks a sample of its loop's SASS takes at
    # the busiest pipe or the issue rate, over the samples this plan
    # draws, on every SM at the SM clock nvidia-smi reads (its maximum:
    # the least time)
    k1c_sass = _loop_sass(_build._library_path("noise_rdm")[1],
                          "planes_kernelILb1E")
    sm_mhz, sm_max_mhz = _sm_clocks()
    n_drawn = sum(num_b * plan.n_pulses * (sg.xlen - sg.pad_front)
                  for sg in plan.segments)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue_ms = lambda clocks: (clocks * n_drawn
                               / (sms * sm_max_mhz * 1e6) * 1e3)
    k1c_issue_ms = issue_ms(k1c_sass["clocks_per_sample"])
    k1c_issue_wide2_ms = issue_ms(k1c_sass["clocks_per_sample_wide2"])
    k1c_bytes_ms = n_planes * 8 / PEAK_HBM * 1e3
    _line("K1c_bound", card=repr(card), sass_loop=k1c_sass,
          busy_card_ms=round(k1c_busy_ms, 5),
          host_ms=round(k1c_host_ms, 5),
          library_busy_card_ms=round(k1c_lib_busy_ms, 5),
          drawn_samples=n_drawn, sm_mhz=sm_mhz, sm_max_mhz=sm_max_mhz,
          issue_ms=round(k1c_issue_ms, 5),
          issue_imad_wide_two_slots_ms=round(k1c_issue_wide2_ms, 5),
          bytes_ms=round(k1c_bytes_ms, 5),
          launches_per_call=val_launches["K1c"])
    k4_ms, k4_plain_ms = _time_pair(
        lambda: nr.noise_rdm(plan, lmat, seed=seed, layout="bvg",
                             rolling=False, beams_per_step=num_b),
        lambda: nr.noise_rdm_plain(
            plan, lmat, nr.philox_planes(plan, seed, num_b, device=dev)))
    k4_1_ms = statistics.median(_event_ms(
        lambda: nr.noise_rdm(plan, lmat, seed=seed, layout="bvg",
                             rolling=False, beams_per_step=1), 10))
    # K4 on a busy card and the host's ms a call, at each beams_per_step,
    # and the profiler's split at 1
    k4_call = lambda bps: (lambda: nr.noise_rdm(
        plan, lmat, seed=seed, layout="bvg", rolling=False,
        beams_per_step=bps))
    k4_busy = {bps: _busy_event_ms(k4_call(bps)) for bps in (num_b, 1, 2)}
    k4_prof = _kernel_profile(k4_call(1), reps=5)
    k4_parts = (("pc_both_passes", "k4_pc_kernel<true>"),
                ("mix", "mix_planes_kernel"), ("dft_gemm", "dft_gemm_kernel"),
                ("add", "add_kernel"))
    k4_split = {name: sum(v[0] for k, v in k4_prof.items() if key in k)
                for name, key in k4_parts}
    k4_seen = {name: sum(v[1] for k, v in k4_prof.items() if key in k)
               for name, key in k4_parts}
    _require(k4_split["pc_both_passes"] > 0.0,
             "the profiler saw K4's drawing PC")
    _line("K4_split", card=repr(card),
          busy_card_ms={b: round(v[0], 4) for b, v in k4_busy.items()},
          host_ms={b: round(v[1], 4) for b, v in k4_busy.items()},
          idle_card_ms={num_b: round(k4_ms, 4), 1: round(k4_1_ms, 4)},
          profile_ms_bps1={k: round(v, 4) for k, v in k4_split.items()},
          profile_launches_recorded_a_call=k4_seen,
          top_kernels=_busy_top({k: v[0] for k, v in k4_prof.items()})[1])
    k1_noise_ms = statistics.median(_event_ms(
        lambda: nr.noise_rdm(plan, lmat, seed=seed, layout="bvg"), 10))
    # K5's library call: torch.normal with x's rails as the mean reads x
    # and writes x + N(0, sigma^2) on each rail, K5's function and bytes
    # (the views launch nothing); torch.randn only draws and writes the
    # cube, half K5's bytes
    k5_sigma = k5._sigma(1.0)
    k5_lib = lambda: torch.view_as_complex(
        torch.normal(torch.view_as_real(zeros), k5_sigma))
    y_lib = k5_lib()
    _require(y_lib.shape == zeros.shape
             and abs(float(torch.view_as_real(y_lib).std()) - k5_sigma)
             <= 1e-3, "K5's library call draws x + N(0, sigma^2)")
    del y_lib
    k5_lib_ms = statistics.median(_event_ms(k5_lib, 10))
    k5_randn_ms = statistics.median(_event_ms(
        lambda: torch.randn(shape, dtype=torch.complex64, device=dev), 10))

    # K1 on the tensor cores: events on a busy and an idle card, host ms a
    # call, the profiler's split, both bounds and the xla route's cuBLAS
    # chain (f32, no TF32)
    k1_call = lambda: nr.noise_rdm(plan, lmat, factors, seed=seed,
                                   layout="bvg")
    k1_busy_ms, k1_host_ms = _busy_event_ms(k1_call)
    k1_split_all = _kernel_ms(k1_call, reps=5)
    k1_split = {name: _named_ms(k1_split_all, key) for name, key in (
        ("K1c_planes", "planes_kernel<"), ("pc_gemm", "pc_gemm_kernel"),
        ("pc_gemm_main", "pc_gemm_kernel<false>"),
        ("pc_gemm_correction", "pc_gemm_kernel<true>"),
        ("mix", "mix_planes_kernel"), ("dft_gemm", "dft_gemm_kernel"),
        ("dft_gemm_main", "dft_gemm_kernel<false>"),
        ("dft_gemm_correction", "dft_gemm_kernel<true>"),
        ("add_and_signal", "add_kernel"))}
    _require(all(v > 0.0 for v in k1_split.values()),
             "the profiler saw K1c's planes, both GEMMs, the mix and the add")
    k1_fp32_bound = _k1_bound_ms(plan, num_b)
    k1_tf32_bound = _k1_bound_ms(plan, num_b, PEAK_TF32, products=3)
    # bytes: the planes read once (planes mode's input) and the map
    # written once
    k1_bytes_ms = (n_planes * 8 + num_b * plan.n_dop * plan.n_gates * 8
                   ) / PEAK_HBM * 1e3
    lx = make_lowrank_stages(perf_config(pallas=False).replace(
        matmul_precision="f32"), pre, device=dev)
    z_x = lx.gen_noise(20261016)
    sig_x = lx.signal_rdm(truth)
    cublas_ms = statistics.median(_event_ms(
        lambda: lx.mix_add(sig_x, lx.mtd(lx.pc(z_x))), 10))
    del z_x, sig_x
    _line("K1_split", card=repr(card), busy_card_ms=round(k1_busy_ms, 4),
          idle_card_ms=round(k1_noise_ms, 4), host_ms=round(k1_host_ms, 4),
          profile_ms={k: round(v, 4) for k, v in k1_split.items()},
          bound_fp32_cuda_cores_ms=round(k1_fp32_bound, 4),
          bound_3xtf32_tensor_cores_ms=round(k1_tf32_bound, 4),
          bytes_ms=round(k1_bytes_ms, 4), cublas_chain_ms=round(cublas_ms, 4))
    k2_call = lambda: ck.goca_cfar_qvg(maps_p, cfg.cfar, num_g, num_v)
    k2_busy_ms, k2_host_ms = _busy_event_ms(k2_call, reps=20)
    _line("K2_split", card=repr(card), busy_card_ms=round(k2_busy_ms, 5),
          idle_card_ms=round(k2_ms, 5), host_ms=round(k2_host_ms, 5),
          instance=ck.k2_geometry(cfg.cfar)._asdict(),
          profile_ms=_kernel_ms(k2_call, reps=10))

    # Monte-Carlo throughput: host clock around a batch of 16 trials that
    # ends in the copy to the host (median of 3, after a warm-up batch)
    tb10 = TargetBatch.make([10000.0], [20.0], [10.0], [10.0])
    mc_rate = {}
    for label, cfg_m, pre_m in (("perf", cfg, pre),
                                ("reference", ref_cfg, ref_pre)):
        trials = make_trial_fn(cfg_m, pre_m, device=dev)
        batch = lambda: trials(tb10, range(16))[1].cpu()
        batch()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            batch()
            walls.append(time.perf_counter() - t0)
        mc_rate[label] = 16 / statistics.median(walls)
        if label == "perf":
            batch_ms = statistics.median(walls) * 1e3
            mc_busy, mc_top = _device_busy_ms(
                lambda: trials(tb10, range(16)), reps=2)
    st_rate = stats.total_targets / st_wall
    for name, ms in (("K1", k1_ms), ("K1 plain", k1_plain_ms),
                     ("K2", k2_ms), ("K2 plain", k2_plain_ms),
                     ("frame", frame_ms),
                     ("K3", k3_ms), ("K3 plain", k3_plain_ms),
                     ("K5", k5_ms), ("K5 plain", k5_plain_ms),
                     ("reference-stream frame (K5 + K3)", ref_ms),
                     ("run_multiframe, per frame", mf_ms),
                     ("K1c", k1c_ms), ("K1c plain", k1c_plain_ms),
                     ("K1c library (torch.rand of the planes)", k1c_lib_ms),
                     ("K4 (13 beams a block)", k4_ms),
                     ("K4 plain", k4_plain_ms),
                     ("K4 (1 beam a block)", k4_1_ms),
                     ("K1 noise only", k1_noise_ms),
                     ("K5 library (torch.normal around x's rails)",
                      k5_lib_ms),
                     ("torch.randn of K5's cube (half its bytes)",
                      k5_randn_ms)):
        _line("time", what=repr(name), ms=round(ms, 4), card=repr(card))
    _line("mc_rate", card=repr(card),
          sweep_trials_per_s={k: round(v, 3) for k, v in mc_rate.items()},
          streaming_targets_per_s=round(st_rate, 3),
          perf_batch16_ms=round(batch_ms, 4),
          perf_batch16_device_busy_ms=round(mc_busy, 4),
          perf_batch16_idle_share=round(1.0 - mc_busy / batch_ms, 4),
          top_kernels=mc_top)

    # ---- 11. where the reference frame's time goes
    stage_ms = _reference_stages(ref_cfg, ref_pre, truth, dev)
    _line("ref_stages", card=repr(card),
          ms={k: round(v, 4) for k, v in stage_ms.items()},
          sum_ms=round(sum(stage_ms.values()), 4))
    ref_kernels = _kernel_ms(lambda: ref_proc(20261016, truth))
    busy_ms, top = _busy_top(ref_kernels)
    k3_in_frame = _named_ms(ref_kernels, "k3_kernel")
    _line("ref_profile", device_busy_ms=round(busy_ms, 4),
          frame_ms=round(ref_ms, 4),
          idle_share=round(1.0 - busy_ms / ref_ms, 4), top_kernels=top,
          k3_kernel_ms=round(k3_in_frame, 4))
    _require(k3_in_frame > 0.0, "the reference frame ran k3_kernel")

    # launches: K1 and K2 from the perf SNR sweep, K3 and K5 from the
    # reference frame, K1c and K4 from the validation path, K7, K9 and K10
    # from noise_rdm_compact, K8 from chain_pallas_pc (the noise-RDM kernel
    # studies) and K6 from one range-sharded PC on 4 ranks (the sum over
    # the ranks); bounds from this run's shapes
    k1_bound = _k1_bound_ms(plan, num_b)
    # K4 reads nothing: the map written once
    k4_bytes_ms = num_b * plan.n_dop * plan.n_gates * 8 / PEAK_HBM * 1e3
    kernels = [
        ("K1 noise RDM (draw mode, rank-K signal): K1c planes + 3xTF32 "
         "strip-GEMM PC + mix + 3xTF32 DFT GEMM; emit_maps and bf16 "
         "output in the maps epilogue add_maps_kernel", "noise_rdm_sm90.cu",
         "radar_tpu/ops/pallas_rdm.py:980", sweeps["perf"]["K1"], k1_err,
         k1_busy_ms, k1_plain_ms, *_bound(k1_tf32_bound, k1_bytes_ms), None,
         {"ms_is": "events around one call, the card kept busy",
          "idle_card_ms": k1_noise_ms, "idle_card_ms_with_signal": k1_ms,
          "host_ms": k1_host_ms, "profile_ms": k1_split,
          "bound_fp32_cuda_cores_ms": k1_fp32_bound,
          "bound_3xtf32_tensor_cores_ms": k1_tf32_bound,
          "bytes_bound_ms": k1_bytes_ms, "cublas_chain_ms": cublas_ms,
          "tracking_launches_a_headline_run": track_launches["K1"],
          **tails_extra}),
        ("K2 2D GOCA-CFAR on qvg maps (TMA-staged, compiled-in window)",
         "cfar.cu", "radar_tpu/ops/pallas_kernels.py:234",
         sweeps["perf"]["K2"], k2_err, k2_busy_ms, k2_plain_ms,
         _bytes_ms(maps_p[:, :num_v, ck.HALO:ck.HALO + num_g], mask, rc),
         "bytes", None,
         {"ms_is": "events around one call, the card kept busy",
          "idle_card_ms": k2_ms, "host_ms": k2_host_ms,
          "tracking_launches_a_headline_run": track_launches["K2"]}),
        ("K3 pair sum + 2D GOCA-CFAR (mask, threshold): the beams walked "
         "through TMA-staged slots, compiled-in window", "cfar.cu",
         "radar_tpu/ops/pallas_kernels.py:292", ref_launches["K3"], k3_err,
         k3_busy_ms, k3_plain_ms, _bytes_ms(mag, m3, t3), "bytes", None,
         {"ms_is": "events around one call, the card kept busy",
          "idle_card_ms": k3_ms, "host_ms": k3_host_ms,
          "profile_ms": _named_ms(k3_profile, "k3_kernel"),
          "tracking_launches_in_10_exact_frames": track_launches["K3"]}),
        ("K5 complex AWGN (Philox + Box-Muller)", "awgn.cu",
         "radar_tpu/ops/pallas_noise.py:106", ref_launches["K5"], k5_err,
         k5_ms, k5_plain_ms, 2 * _bytes_ms(zeros), "bytes", k5_lib_ms,
         {"library_call": "torch.normal(torch.view_as_real(x), sigma)",
          "randn_only_ms": k5_randn_ms,
          "randn_only_note": "torch.randn draws and writes the cube only: "
                             "half K5's bytes (x read, x + n written)"}),
        ("K1c noise-plane export (draw mode's Philox planes)", "noise_rdm.cu",
         "radar_tpu/ops/pallas_rdm.py:1052", val_launches["K1c"], k1c_err,
         k1c_busy_ms, k1c_plain_ms,
         *_bound(k1c_issue_ms, k1c_bytes_ms), k1c_lib_busy_ms,
         {"ms_is": "events around one call, the card kept busy",
          "idle_card_ms": k1c_ms, "host_ms": k1c_host_ms,
          "library_idle_card_ms": k1c_lib_ms,
          "bytes_bound_ms": k1c_bytes_ms, "issue_bound_ms": k1c_issue_ms,
          "issue_bound_imad_wide_two_slots_ms": k1c_issue_wide2_ms,
          "clocks_per_sample": k1c_sass["clocks_per_sample"],
          "sm_max_mhz": sm_max_mhz}),
        ("K4 noise RDM, window schedule: K1's 3xTF32 GEMMs, the PC's data "
         "drawn in its blocks (13 beams walked a block)",
         "noise_rdm_sm90.cu", "radar_tpu/ops/pallas_rdm.py:980 "
         "(rolling=False)", val_launches["K4"], k4_err, k4_busy[num_b][0],
         k4_plain_ms, *_bound(k1_tf32_bound, k4_bytes_ms), None,
         {"ms_is": "events around one call, the card kept busy",
          "idle_card_ms": k4_ms, "host_ms": k4_busy[num_b][1],
          "busy_card_ms_1_beam_a_block": k4_busy[1][0],
          "idle_card_ms_1_beam_a_block": k4_1_ms,
          "busy_card_ms_2_beams_a_block": k4_busy[2][0],
          "profile_ms_1_beam_a_block": k4_split,
          "bound_3xtf32_tensor_cores_ms": k1_tf32_bound,
          "bound_fp32_cuda_cores_ms": k1_bound,
          "bytes_bound_ms": k4_bytes_ms})] + study_rows
    # a row may end with a dict of extra keys
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": "radar_tpu_torch/csrc/" + src, "replaces": rep,
         "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": pms,
         "bound_ms": bms, "bound_by": by, "library_ms": lib,
         **(extra[0] if extra else {})}
        for name, src, rep, n, err, ms, pms, bms, by, lib, *extra
        in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
