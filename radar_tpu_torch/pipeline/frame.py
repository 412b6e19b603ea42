"""Single-frame processor — port of ``radar_tpu/pipeline/frame.py:40-348``.

Three streams produce the range-Doppler map (RDM), as in the JAX code:

- the exact reference stream (the default; always under
  ``return_intermediates``): per-element echo synthesis -> AWGN
  (``torch.randn`` for ``noise_impl="threefry"``, kernel K5 for
  ``"pallas"``) -> DBF -> pulse compression -> MTD;
- the fused stream (``fused_synth_dbf``): echoes synthesized in beam space
  plus beam-space AWGN -> pulse compression -> MTD;
- the rank-K perf stream (``fused_synth_dbf`` and ``lowrank_rdm``), by
  ``noise_rdm_impl``: kernel K1 draws the noise and forms the whole RDM
  (``"pallas_prng"``), K1 takes torch-drawn planes (``"pallas"``), or the
  plain chain PC -> MTD -> mix runs on white noise (``"xla"``), each added
  to the rank-K signal RDM (``pipeline/lowrank.py``).

Two tails take the RDM to detections:

- vgq (the default): pair sums + 2D CFAR in kernel K3 -> first-K
  extraction over [V, G, pairs] -> spline/monopulse estimation;
- qvg (``use_pallas_cfar``, and always on the perf stream, whose
  detections JAX makes bit-identical either way): padded qvg pair sums ->
  kernel K2 -> extraction from K2's row counts -> estimation.

Both end in the two clustering stages. Variant flags the port does not run
raise ``NotImplementedError`` naming the flag; the precedence warnings of
``radar_tpu/pipeline/frame.py:146-180`` are given where their flags are
not refused. JAX's ``extract_impl="rowfetch"`` runs the direct extraction,
bit-identical in all cases (``radar_tpu/ops/cfar.py:387-389``).

Frame seeds. Where JAX takes a ``jax.random`` key, the port takes an
integer frame seed: it seeds the ``torch.Generator`` of the threefry-style
draws, and its two 32-bit words key the Philox streams of K1 and K5
(``ops/noise_rdm.py::seed_words``).

The stages are built once by ``make_frame_stages``; the frame processor
and the Monte-Carlo trial function (``pipeline/montecarlo.py``) compose
them, as JAX's trial function reuses the frame's stages.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from ..cluster.stages import ClusteredTargets, cluster_stage1, cluster_stage2
from ..config.params import RadarConfig
from ..measure.estimate import ParamDetections, estimate_parameters
from ..ops.awgn import awgn
from ..ops.cfar import Detections, extract_detections
from ..ops.cfar_kernel import (HALO, goca_cfar_2d_fused, goca_cfar_qvg,
                               pad_maps_qvg)
from ..ops.dbf import dbf, dbf_weights_effective_np
from ..ops.mtd import make_mtd_matrix, mtd, mtd_matmul
from ..ops.noise_rdm import seed_words
from ..ops.pulse_compression import (make_matmul_plan, make_plan,
                                     pulse_compress, pulse_compress_matmul,
                                     to_device)
from ..sim.echo import (add_noise, add_noise_beamspace, beam_noise_factor,
                        seeded_generator, synthesize_echo_beams,
                        synthesize_echoes, white_complex_noise)
from ..waveform.precompute import Precomputed, precompute
from .lowrank import make_lowrank_stages


class MeasureConsts(NamedTuple):
    """Constants of measure/estimate.py, as f32 tensors on the device."""

    range_axis: torch.Tensor
    velocity_axis: torch.Tensor
    delta_r: float
    delta_v: float
    beam_angles_deg: torch.Tensor
    k_slopes_lut: torch.Tensor
    q_range: torch.Tensor
    q_vel: torch.Tensor


class FrameResult(NamedTuple):
    """Final per-frame output (ref ``final_targets``) plus diagnostics."""

    targets: ClusteredTargets
    num_raw_detections: torch.Tensor   # int32 (true count, may exceed cap)
    num_final: torch.Tensor            # int32


class FrameIntermediates(NamedTuple):
    """Stage taps of the reference stream (``return_intermediates``), in
    JAX's layouts: raw_iq [P, S, C], beams [P, S, B], pc [P, G, B], rdm
    [V, G, B], pair_maps [V, G, pairs]."""

    raw_iq: torch.Tensor
    beams: torch.Tensor
    pc: torch.Tensor
    rdm: torch.Tensor
    pair_maps: torch.Tensor
    detections: Detections
    params: ParamDetections
    stage1: ClusteredTargets
    result: FrameResult


def measure_consts(cfg: RadarConfig, precomp: Precomputed, *,
                   device) -> MeasureConsts:
    n_dop = cfg.mtd_fft_len or cfg.sig.prt_num
    if n_dop == cfg.sig.prt_num:
        vel_axis, delta_v = precomp.velocity_axis, precomp.delta_v
    else:
        # zero-padded MTD (v7_7:150): the axis respans the same ambiguity
        # window over n_dop bins
        v_max = cfg.sig.v_max
        vel_axis = np.linspace(-v_max / 2, v_max / 2, n_dop)
        delta_v = v_max / n_dop
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return MeasureConsts(
        range_axis=t(precomp.range_axis), velocity_axis=t(vel_axis),
        delta_r=float(precomp.delta_r), delta_v=float(delta_v),
        beam_angles_deg=t(precomp.beam_angles_deg),
        k_slopes_lut=t(precomp.k_slopes_lut), q_range=t(precomp.q_range),
        q_vel=t(precomp.q_vel))


# (flag, value the port does not run)
_REFUSED = (("kernel_maps", True), ("beams_major_tail", True),
            ("tail_from_rdm", True), ("monopulse_complex", True),
            ("monopulse_refined", True), ("kernel_out_bf16", True))
_CHOICES = (("noise_impl", ("threefry", "pallas")),
            ("pc_method", ("matmul", "fft")),
            ("mtd_method", ("matmul", "fft")))


def check_config(cfg: RadarConfig) -> None:
    """Refuse what the port does not run; give JAX's precedence warnings
    for what it runs."""
    for flag, refused in _REFUSED:
        if getattr(cfg, flag) == refused:
            raise NotImplementedError(f"cfg.{flag}={refused!r} is not ported")
    for flag, choices in _CHOICES:
        if getattr(cfg, flag) not in choices:
            raise ValueError(f"cfg.{flag}={getattr(cfg, flag)!r}: not one "
                             f"of {choices}")
    if cfg.cluster.keep_pair_mode:
        raise NotImplementedError(
            "cfg.cluster.keep_pair_mode=True is not ported")
    if cfg.cfar.means_impl != "shift":
        raise NotImplementedError(
            f"cfg.cfar.means_impl={cfg.cfar.means_impl!r} is not ported")
    if cfg.extract_native_scan:
        if not cfg.use_pallas_cfar:
            # JAX runs it on the vgq tail, keeping another subset of hits
            # beyond capacity (radar_tpu/ops/cfar.py:380-385)
            raise NotImplementedError(
                "cfg.extract_native_scan=True is not ported")
        warnings.warn(
            "cfg.extract_native_scan is ignored when cfg.use_pallas_cfar "
            "is set: the qvg tail has no native-scan extraction",
            stacklevel=3)


def detection_tail(cfg: RadarConfig, mc: MeasureConsts, mag: torch.Tensor,
                   rdm: torch.Tensor, rdm_layout: str, qvg: bool):
    """Detections, estimates and clusters from the magnitudes [B, V, G]
    and the complex RDM (``rdm_layout`` "vgb" or "bvg"): the qvg tail (K2)
    or the vgq tail (K3). Returns (pair maps [V, G, pairs], detections,
    parameters, stage-1 clusters, FrameResult)."""
    num_v, num_g = mag.shape[1:]
    cap, ip = cfg.cfar.max_detections, cfg.interp
    if qvg:
        maps_p = pad_maps_qvg(mag[:-1] + mag[1:])
        mask, rc = goca_cfar_qvg(maps_p, cfg.cfar, num_g, num_v)
        maps = maps_p[:, :num_v, HALO:HALO + num_g]               # [Q, V, G]
        dets = extract_detections(mask, maps, cap, layout="qvg",
                                  row_counts=rc)
        layout = "qvg"
    else:
        mask, _ = goca_cfar_2d_fused(mag, cfg.cfar)               # [V, G, Q]
        # the tail gathers <= cap stencils of the pair sums: a [V, G, Q]
        # view of one elementwise pass
        maps = (mag[:-1] + mag[1:]).permute(1, 2, 0)
        dets = extract_detections(mask, maps, cap, layout="vgq")
        layout = "vgq"
    params = estimate_parameters(
        dets, maps, rdm, mc, ip.extra_dots, ip.r_interp_times,
        ip.v_interp_times, layout=rdm_layout, maps_layout=layout)
    s1 = cluster_stage1(params, cfg.cluster)
    final = cluster_stage2(s1, cfg.cluster)
    result = FrameResult(targets=final, num_raw_detections=dets.count,
                         num_final=final.count.to(torch.int32))
    pair_maps = maps.permute(1, 2, 0) if qvg else maps
    return pair_maps, dets, params, s1, result


class FrameStages(NamedTuple):
    """The stages of one frame, composed by ``make_frame_processor`` and by
    the Monte-Carlo trial function (``pipeline/montecarlo.py``), which
    synthesizes once per SNR point and runs the rest per trial."""

    cfg: RadarConfig
    mc: MeasureConsts
    lowrank: object     # LowrankStages of the rank-K stream, else None
    synth: object       # targets -> noiseless raw [P,S,C] or beams [P,S,B]
    chain: object       # (echo, frame_seed, noise, kernel_noise) ->
                        # (noisy raw, beams, pc, rdm [V, G, B])
    pc: object          # beams [P, S, B] -> pc [P, G, B] (any pulse count)
    mtd: object         # pc [P, G, B] -> rdm [V, G, B] (any gate count)
    qvg: bool           # the tail: qvg (K2) or vgq (K3)

    def detect(self, rdm: torch.Tensor, rdm_layout: str):
        """``detection_tail`` on an RDM in ``rdm_layout``."""
        mag = (rdm.abs() if rdm_layout == "bvg"
               else rdm.permute(2, 0, 1).abs().contiguous())    # [B, V, G]
        return detection_tail(self.cfg, self.mc, mag, rdm, rdm_layout,
                              self.qvg)


def make_frame_stages(cfg: RadarConfig, precomp: Precomputed | None = None,
                      *, device, return_intermediates: bool = False
                      ) -> FrameStages:
    """The frame's stages on ``device``; raises for a CUDA device without
    CUDA and for what the port does not run."""
    check_config(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for, but CUDA is not "
                           "available")
    if precomp is None:
        precomp = precompute(cfg)
    fused = cfg.fused_synth_dbf and not return_intermediates
    mc = measure_consts(cfg, precomp, device=device)
    if cfg.lowrank_rdm and fused:
        # the rank-K stream always takes the qvg tail, whose detections JAX
        # makes bit-identical to the vgq tail
        return FrameStages(cfg, mc,
                           make_lowrank_stages(cfg, precomp, device=device),
                           None, None, None, None, qvg=True)
    c64 = torch.complex64
    w_eff = dbf_weights_effective_np(precomp.dbf_w, cfg.dbf_variant)
    if fused:
        mix = np.ascontiguousarray(w_eff.T)                          # [C, B]
        l_t = torch.as_tensor(beam_noise_factor(w_eff)).to(device, c64)
    prec = cfg.matmul_precision
    mplan = (to_device(make_matmul_plan(precomp), device)
             if cfg.pc_method == "matmul" else None)
    pplan = make_plan(precomp)
    mtd_t = (torch.as_tensor(make_mtd_matrix(
        precomp.mtd_win, cfg.sig.prt_num, cfg.mtd_fft_len)).to(device, c64)
        if cfg.mtd_method == "matmul" else None)

    def synth(targets):
        if fused:
            return synthesize_echo_beams(targets, precomp, cfg, mix,
                                         device=device)
        return synthesize_echoes(targets, precomp, cfg, device=device)

    def chain(echo, frame_seed, noise=None, kernel_noise=True):
        """Noise and processing of a noiseless echo. ``kernel_noise=False``
        draws the reference stream's AWGN with ``torch.randn`` whatever
        ``noise_impl`` says, as the JAX trial function does."""
        if noise is not None:
            noise = torch.as_tensor(noise, device=device)
        if fused:
            if noise is None:
                noise = white_complex_noise(
                    echo.shape, seeded_generator(frame_seed, device),
                    device=device)
            elif noise.shape != echo.shape:
                raise ValueError(f"the fused stream takes white beam noise "
                                 f"{tuple(echo.shape)}, got "
                                 f"{tuple(noise.shape)}")
            noisy, beams = None, add_noise_beamspace(echo, l_t, noise)
        else:
            if noise is not None:
                if noise.shape != echo.shape:
                    raise ValueError(f"the reference stream takes channel "
                                     f"AWGN {tuple(echo.shape)}, got "
                                     f"{tuple(noise.shape)}")
                noisy = echo + noise.to(c64)
            elif kernel_noise and cfg.noise_impl == "pallas":
                noisy = awgn(echo, seed_words(frame_seed))
            else:
                noisy = add_noise(echo, seeded_generator(frame_seed, device))
            beams = dbf(noisy, precomp.dbf_w, cfg.dbf_variant)
        pc = pc_stage(beams)
        return noisy, beams, pc, mtd_stage(pc)

    def pc_stage(beams):
        if mplan is not None:
            return pulse_compress_matmul(beams, mplan, precision=prec)
        return pulse_compress(beams, precomp, pplan)

    def mtd_stage(pc):
        if mtd_t is not None:
            return mtd_matmul(pc, mtd_t, precision=prec)
        return mtd(pc, precomp.mtd_win, cfg.mtd_fft_len)          # [V, G, B]

    return FrameStages(cfg, mc, None, synth, chain, pc_stage, mtd_stage,
                       qvg=cfg.use_pallas_cfar)


def make_frame_processor(cfg: RadarConfig,
                         precomp: Precomputed | None = None, *,
                         device="cuda", return_intermediates: bool = False):
    """Returns ``process(frame_seed, targets, noise=None, noise_planes=None)
    -> FrameResult`` (``FrameIntermediates`` under
    ``return_intermediates``) running on ``device`` (the card by default;
    ``"cpu"`` runs the kernels' plain versions). On a CUDA device the
    kernels run (K1, K2, K3, K5 as the branch needs them).

    Injected noise replaces the stream's draws, so tests can feed both
    packages the same noise: ``noise`` is the [P, S, C] complex AWGN cube
    added to the raw echo on the reference stream, the [P, S, B] white
    CN(0,1) cube before the beam mix on the fused stream, or the white z
    [P, S(_compact), B] of the rank-K stream's xla route;
    ``noise_planes`` (per-segment (re, im) [B, P, >= xlen] f32 planes, e.g.
    ``ops.noise_rdm.planes_from_compact(z, rplan)``) replaces the draws of
    the rank-K stream's kernel routes. The wrong kind raises."""
    st = make_frame_stages(cfg, precomp, device=device,
                           return_intermediates=return_intermediates)
    lr = st.lowrank
    if lr is not None:
        def process(frame_seed: int, targets, noise=None,
                    noise_planes=None) -> FrameResult:
            if lr.impl == "pallas_prng":
                if noise is not None:
                    raise ValueError("the rank-K perf stream takes injected "
                                     "noise as noise_planes=")
                # the complete RDM from one K1 call (signal fused)
                rdm = lr.noise_rdm_sig(frame_seed, targets, layout="bvg",
                                       planes=noise_planes)
            else:
                rdm = lr.noisy_rdm(lr.signal_rdm(targets, lr.rdm_layout),
                                   frame_seed, noise, noise_planes)
            return st.detect(rdm, lr.rdm_layout)[-1]

        process.stages = lr
        return process

    def process(frame_seed: int, targets, noise=None, noise_planes=None):
        if noise_planes is not None:
            raise ValueError("noise_planes= drives the rank-K perf stream "
                             "only; this stream takes noise=")
        noisy, beams, pc, rdm = st.chain(st.synth(targets), frame_seed,
                                         noise)
        pair_maps, dets, params, s1, result = st.detect(rdm, "vgb")
        if return_intermediates:
            return FrameIntermediates(
                raw_iq=noisy, beams=beams, pc=pc, rdm=rdm,
                pair_maps=pair_maps, detections=dets, params=params,
                stage1=s1, result=result)
        return result

    return process
