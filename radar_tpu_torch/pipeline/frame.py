"""Single-frame processor — port of ``radar_tpu/pipeline/frame.py:40-97,
182-319`` for the flagship perf configuration with the kernel CFAR
(``perf_config().replace(use_pallas_cfar=True)`` in JAX terms):

  rank-K signal factors -> K1: noise draws + PC + MTD + beam mix + signal
  -> 12 adjacent-beam sum maps (qvg) -> K2: 2D GOCA-CFAR + row counts
  -> first-K extraction -> spline/monopulse estimation -> two clusterings

The JAX package runs the same detections with or without its Pallas CFAR
(bit-identical by construction), so the port accepts either value of
``use_pallas_cfar`` and always runs K2. Every other variant flag it does
not run raises ``NotImplementedError`` naming the flag.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cluster.stages import ClusteredTargets, cluster_stage1, cluster_stage2
from ..config.params import RadarConfig
from ..measure.estimate import estimate_parameters
from ..ops.cfar import extract_detections
from ..ops.cfar_kernel import HALO, goca_cfar_qvg, pad_maps_qvg
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


def measure_consts(precomp: Precomputed, *, device) -> MeasureConsts:
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return MeasureConsts(
        range_axis=t(precomp.range_axis),
        velocity_axis=t(precomp.velocity_axis),
        delta_r=float(precomp.delta_r), delta_v=float(precomp.delta_v),
        beam_angles_deg=t(precomp.beam_angles_deg),
        k_slopes_lut=t(precomp.k_slopes_lut), q_range=t(precomp.q_range),
        q_vel=t(precomp.q_vel))


# (flag, value the port does not run)
_REFUSED = (("fused_synth_dbf", False), ("lowrank_rdm", False),
            ("kernel_maps", True), ("beams_major_tail", True),
            ("tail_from_rdm", True), ("monopulse_complex", True),
            ("monopulse_refined", True))


def check_config(cfg: RadarConfig) -> None:
    for flag, refused in _REFUSED:
        if getattr(cfg, flag) == refused:
            raise NotImplementedError(
                f"cfg.{flag}={refused!r} is not ported (the port runs the "
                "perf-config frame path)")
    if cfg.cluster.keep_pair_mode:
        raise NotImplementedError(
            "cfg.cluster.keep_pair_mode=True is not ported")
    if cfg.cfar.means_impl != "shift":
        raise NotImplementedError(
            f"cfg.cfar.means_impl={cfg.cfar.means_impl!r} is not ported")


def make_frame_processor(cfg: RadarConfig,
                         precomp: Precomputed | None = None, *, device):
    """Returns ``process(frame_seed, targets, noise_planes=None) ->
    FrameResult`` running on ``device``. On a CUDA device the RDM and the
    CFAR run as kernels K1 and K2; on the CPU as their plain versions.

    ``noise_planes`` (per-segment (re, im) [B, P, >= xlen] f32 white
    planes, e.g. ``ops.noise_rdm.planes_from_compact(z, rplan)``) replaces
    the Philox draws, so tests can inject the reference's noise."""
    check_config(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for, but CUDA is not "
                           "available")
    if precomp is None:
        precomp = precompute(cfg)
    lr = make_lowrank_stages(cfg, precomp, device=device)
    mc = measure_consts(precomp, device=device)
    ip = cfg.interp
    num_v, num_g = lr.rplan.n_dop, lr.rplan.n_gates

    def process(frame_seed: int, targets, noise_planes=None) -> FrameResult:
        rdm = lr.noise_rdm_sig(frame_seed, targets, layout="bvg",
                               planes=noise_planes)               # [B, V, G]
        mag = rdm.abs()
        maps_p = pad_maps_qvg(mag[:-1] + mag[1:])
        mask, rc = goca_cfar_qvg(maps_p, cfg.cfar, num_g, num_v)
        maps_q = maps_p[:, :num_v, HALO:HALO + num_g]             # [Q, V, G]
        dets = extract_detections(mask, maps_q, cfg.cfar.max_detections,
                                  layout="qvg", row_counts=rc)
        params = estimate_parameters(
            dets, maps_q, rdm, mc, ip.extra_dots, ip.r_interp_times,
            ip.v_interp_times, layout="bvg", maps_layout="qvg")
        final = cluster_stage2(cluster_stage1(params, cfg.cluster),
                               cfg.cluster)
        return FrameResult(targets=final, num_raw_detections=dets.count,
                           num_final=final.count.to(torch.int32))

    process.stages = lr
    return process
