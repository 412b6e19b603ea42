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

Tails take the RDM to detections, chosen as JAX chooses them
(``radar_tpu/pipeline/frame.py:137-180``), with its precedence warnings:

- vgq (the default): pair sums + 2D CFAR in kernel K3 -> first-K
  extraction over [V, G, pairs] (``extract_native_scan``: JAX's native
  scan) -> spline/monopulse estimation; ``tail_from_rdm`` gathers the
  amplitudes and stencils from the RDM, so the [V, G, pairs] maps are
  never made;
- qvg (``use_pallas_cfar``, and the rank-K stream, whose detections JAX
  makes bit-identical to the vgq tail's under shift means): padded qvg
  pair sums -> kernel K2 -> extraction from K2's row counts -> estimation;
- kernel maps (``kernel_maps``, the rank-K stream on ``"pallas_prng"``):
  K1 writes the padded qvg pair maps of its unrounded map itself, then
  the qvg tail;
- qgv (``beams_major_tail``, the rank-K stream's kernel routes): [pairs,
  G, V] pair sums -> CFAR -> extraction -> estimation on the [B, V, G] RDM.

Under ``cfar.means_impl="matmul"`` every tail whose JAX counterpart runs
XLA's CFAR takes the plain CFAR with the matmul range means in JAX's
layout (K3 and the rank-K stream's K2 shortcut hold only for shift
means); ``use_pallas_cfar``'s K2 ignores the flag, as JAX's kernel does.
All end in the two clustering stages (``cluster.keep_pair_mode``: the
modal pair index). JAX's ``extract_impl="rowfetch"`` runs the direct
extraction, bit-identical in all cases (``radar_tpu/ops/cfar.py:387-389``).

Frame seeds. Where JAX takes a ``jax.random`` key, the port takes an
integer frame seed: it seeds the ``torch.Generator`` of the threefry-style
draws, and its two 32-bit words key the Philox streams of K1 and K5
(``ops/noise_rdm.py::seed_words``).

The stages are built once by ``make_frame_stages``; the frame processor
and the Monte-Carlo trial function (``pipeline/montecarlo.py``) compose
them, as JAX's trial function reuses the frame's stages.

On a card the tail runs as one CUDA graph (``FrameStages.detect``): the
first call of a tail, RDM layout, shape, strides, dtype and maps input
runs it eagerly once and captures it; every call then copies its RDM
(and K1's maps) into the graph's inputs, replays it and clones the
``FrameResult`` out, with no host read (JAX jit-compiles the same tail).
CPU tensors and ``return_intermediates`` run the tail eagerly.
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
from ..ops.cfar import (Detections, extract_detections, goca_cfar_2d,
                        pair_sum_maps_bm)
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
from ..utils.profiling import host_to_device, span
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


_CHOICES = (("noise_impl", ("threefry", "pallas")),
            ("pc_method", ("matmul", "fft")),
            ("mtd_method", ("matmul", "fft")),
            ("extract_impl", ("direct", "rowfetch")))


def check_config(cfg: RadarConfig) -> None:
    """Refuse flag values the port does not know."""
    for flag, choices in _CHOICES:
        if getattr(cfg, flag) not in choices:
            raise ValueError(f"cfg.{flag}={getattr(cfg, flag)!r}: not one "
                             f"of {choices}")
    if cfg.cfar.means_impl not in ("shift", "matmul"):
        raise ValueError(f"cfg.cfar.means_impl={cfg.cfar.means_impl!r}: "
                         "not one of ('shift', 'matmul')")


def kernel_tail(cfg: RadarConfig, lowrank: bool) -> str | None:
    """The frame's kernel-layout tail, "kernel_maps" or "qgv"
    (``beams_major_tail``), or None; gives JAX's precedence warnings
    (``radar_tpu/pipeline/frame.py:137-180``) for the flags it ignores."""
    km = (cfg.kernel_maps and lowrank
          and cfg.noise_rdm_impl == "pallas_prng")
    bm = (cfg.beams_major_tail and lowrank
          and cfg.noise_rdm_impl in ("pallas", "pallas_prng"))
    if km or bm:
        branch = "kernel_maps" if km else "beams_major_tail"
        for flag in ("use_pallas_cfar", "extract_native_scan"):
            if getattr(cfg, flag):
                warnings.warn(
                    f"cfg.{flag} is ignored when cfg.{branch} is active: "
                    f"the {branch} tail uses its own CFAR/extraction "
                    "layout", stacklevel=4)
        if km and cfg.beams_major_tail:
            warnings.warn("cfg.kernel_maps takes precedence over "
                          "cfg.beams_major_tail (both set)", stacklevel=4)
        return "kernel_maps" if km else "qgv"
    if cfg.use_pallas_cfar:
        if cfg.tail_from_rdm:
            warnings.warn(
                "cfg.use_pallas_cfar takes precedence over "
                "cfg.tail_from_rdm (both set): the Pallas-CFAR tail always "
                "materializes the qvg pair-sum maps", stacklevel=4)
        if cfg.extract_native_scan:
            warnings.warn(
                "cfg.extract_native_scan is ignored when cfg.use_pallas_cfar "
                "is set: the qvg tail has no native-scan extraction",
                stacklevel=4)
    elif cfg.tail_from_rdm and (cfg.extract_impl != "direct"
                                or cfg.extract_native_scan):
        warnings.warn(
            "cfg.tail_from_rdm is ignored unless extract_impl='direct' and "
            "extract_native_scan=False: falling back to the materialized-"
            "maps tail", stacklevel=4)
    return None


def select_tail(cfg: RadarConfig, lowrank: bool, *, pallas_cfar: bool,
                intermediates: bool = False) -> tuple[str, bool]:
    """(tail, maps-free) of an RDM: "qvg" (K2) under ``pallas_cfar`` (JAX's
    use_pallas_cfar tail) and on the rank-K stream under shift means, whose
    detections equal the vgq tail's bit for bit; else "vgq", maps-free
    under JAX's ``tail_from_rdm`` rule."""
    tfr = (cfg.tail_from_rdm and cfg.extract_impl == "direct"
           and not cfg.extract_native_scan and not intermediates)
    if pallas_cfar:
        return "qvg", False
    if (lowrank and cfg.cfar.means_impl == "shift"
            and not cfg.extract_native_scan and not tfr):
        return "qvg", False
    return "vgq", tfr


def _estimate_and_cluster(cfg: RadarConfig, mc: MeasureConsts,
                          dets: Detections, maps, rdm, rdm_layout: str,
                          maps_layout: str | None):
    ip = cfg.interp
    with span("estimate"):
        params = estimate_parameters(
            dets, maps, rdm, mc, ip.extra_dots, ip.r_interp_times,
            ip.v_interp_times, layout=rdm_layout, maps_layout=maps_layout,
            monopulse_complex=cfg.monopulse_complex,
            monopulse_refined=cfg.monopulse_refined)
    with span("cluster1"):
        s1 = cluster_stage1(params, cfg.cluster)
    with span("cluster2"):
        final = cluster_stage2(s1, cfg.cluster)
        result = FrameResult(targets=final, num_raw_detections=dets.count,
                             num_final=final.count.to(torch.int32))
    return params, s1, result


def detection_tail(cfg: RadarConfig, mc: MeasureConsts, rdm: torch.Tensor,
                   rdm_layout: str, tail: str, *, tfr: bool = False,
                   maps_p: torch.Tensor | None = None):
    """Detections, estimates and clusters of the complex RDM
    (``rdm_layout`` "vgb" or "bvg") through ``tail``:

    - "qvg": padded qvg pair sums (``maps_p``, K1's under kernel_maps, else
      made here) -> K2 -> extraction from its row counts; the plain qvg
      CFAR with matmul means under kernel_maps and ``means_impl="matmul"``;
    - "vgq": K3 on the magnitudes (the plain vgq CFAR under matmul means)
      -> extraction (native scan per ``cfg``) from the [V, G, pairs] pair
      sums, or, ``tfr``, from the RDM;
    - "qgv": [pairs, G, V] pair sums of a "bvg" RDM -> CFAR -> extraction.

    Returns (pair maps [V, G, pairs] or None, detections, parameters,
    stage-1 clusters, FrameResult). Its stages are the spans ``rt.cfar``
    (magnitudes, pair sums and the CFAR), ``rt.extract``, ``rt.estimate``,
    ``rt.cluster1`` and ``rt.cluster2``, one each a call."""
    cap, matmul = cfg.cfar.max_detections, cfg.cfar.means_impl == "matmul"
    bvg = rdm_layout == "bvg"
    if tail == "qgv":
        if not bvg:
            raise ValueError("the qgv tail takes a 'bvg' RDM")
        with span("cfar"):
            maps = pair_sum_maps_bm(rdm)                          # [Q, G, V]
            mask, _ = goca_cfar_2d(maps, cfg.cfar, layout="qgv")
        with span("extract"):
            dets = extract_detections(mask, maps, cap, layout="qgv")
        return (None, dets, *_estimate_and_cluster(cfg, mc, dets, maps, rdm,
                                                   "bvg", "qgv"))
    num_v, num_g = rdm.shape[1:] if bvg else rdm.shape[:2]
    if tail == "qvg":
        with span("cfar"):
            if maps_p is None:
                mag = rdm.abs() if bvg else rdm.permute(2, 0, 1).abs()
                maps_p = pad_maps_qvg(mag[:-1] + mag[1:])
                kernel = True
            else:
                kernel = not matmul
            maps = maps_p[:, :num_v, HALO:HALO + num_g]           # [Q, V, G]
            rc = None
            if kernel:
                mask, rc = goca_cfar_qvg(maps_p, cfg.cfar, num_g, num_v)
            else:
                mask, _ = goca_cfar_2d(maps, cfg.cfar, layout="qvg")
        with span("extract"):
            dets = extract_detections(mask, maps, cap, layout="qvg",
                                      row_counts=rc)
        return (maps.permute(1, 2, 0), dets,
                *_estimate_and_cluster(cfg, mc, dets, maps, rdm, rdm_layout,
                                       "qvg"))
    if tail != "vgq":
        raise ValueError(f"unknown tail {tail!r}")
    with span("cfar"):
        mag = (rdm.abs() if bvg
               else rdm.permute(2, 0, 1).abs().contiguous())   # [B, V, G]
        maps = None
        if matmul:
            maps = (mag[:-1] + mag[1:]).permute(1, 2, 0)          # [V, G, Q]
            mask, _ = goca_cfar_2d(maps, cfg.cfar)
        else:
            mask, _ = goca_cfar_2d_fused(mag, cfg.cfar)           # [V, G, Q]
    if tfr:
        # the amplitudes and stencils come from the RDM ([V, G, B] view)
        rdm_v = rdm.permute(1, 2, 0) if bvg else rdm
        with span("extract"):
            dets = extract_detections(mask, None, cap, layout="vgq",
                                      rdm=rdm_v)
        return (None, dets, *_estimate_and_cluster(cfg, mc, dets, None,
                                                   rdm_v, "vgb", None))
    with span("extract"):
        if maps is None:
            # the tail gathers <= cap stencils of the pair sums: a
            # [V, G, Q] view of one elementwise pass
            maps = (mag[:-1] + mag[1:]).permute(1, 2, 0)
        dets = extract_detections(mask, maps, cap, layout="vgq",
                                  native_scan=cfg.extract_native_scan)
    return (maps, dets, *_estimate_and_cluster(cfg, mc, dets, maps, rdm,
                                               rdm_layout, "vgq"))


tail_graph_captures = 0   # CUDA graphs of the detection tail captured
tail_graph_replays = 0    # and replayed


class _TailGraph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    rdm: torch.Tensor               # its static inputs
    maps_p: torch.Tensor | None
    result: FrameResult             # its static outputs


def _capture_tail(st, rdm, rdm_layout: str, tail: str, maps_p) -> _TailGraph:
    """``detection_tail`` on static copies of the inputs, run once on a
    side stream to warm it up (the ``torch.cuda.graphs`` rule), then
    captured. The tail's kernels count both calls in their launch counters;
    a replay launches the graph alone (``tail_graph_replays``)."""
    global tail_graph_captures

    def run():
        return detection_tail(st.cfg, st.mc, static_rdm, rdm_layout, tail,
                              tfr=st.tfr, maps_p=static_maps)[-1]

    static_rdm = torch.empty_like(rdm).copy_(rdm)
    static_maps = (None if maps_p is None
                   else torch.empty_like(maps_p).copy_(maps_p))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        result = run()
    tail_graph_captures += 1
    return _TailGraph(graph, static_rdm, static_maps, result)


def _replay_tail(g: _TailGraph, rdm, maps_p) -> FrameResult:
    """The captured tail on ``rdm`` (and ``maps_p``): copied in, replayed,
    its FrameResult cloned out, so no two calls share memory."""
    global tail_graph_replays
    g.rdm.copy_(rdm)
    if maps_p is not None:
        g.maps_p.copy_(maps_p)
    g.graph.replay()
    tail_graph_replays += 1
    t = g.result.targets
    return FrameResult(
        ClusteredTargets(*(None if x is None else x.clone() for x in t)),
        g.result.num_raw_detections.clone(), g.result.num_final.clone())


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
    tail: str           # "kernel_maps", "qgv", "qvg" or "vgq"
    tfr: bool = False   # the vgq tail gathers from the RDM (tail_from_rdm)
    graphs: dict | None = None   # the tail's CUDA graphs by key; None: eager

    def detect(self, rdm: torch.Tensor, rdm_layout: str, maps_p=None):
        """``detection_tail`` on an RDM in ``rdm_layout`` (and, on the
        kernel-maps tail, K1's padded maps ``maps_p``). On a card, with
        ``graphs``, one replay of the tail's CUDA graph, captured at the
        first call with its key: the copy-in, the replay and the clones
        form the call's one ``rt.cfar`` span, and only the FrameResult is
        returned (the other slots None)."""
        tail = "qvg" if self.tail == "kernel_maps" else self.tail
        if self.graphs is None or not rdm.is_cuda:
            return detection_tail(self.cfg, self.mc, rdm, rdm_layout, tail,
                                  tfr=self.tfr, maps_p=maps_p)
        key = (tail, rdm_layout, rdm.device, rdm.dtype, tuple(rdm.shape),
               rdm.stride(), None if maps_p is None else
               (maps_p.dtype, tuple(maps_p.shape), maps_p.stride()))
        with torch.cuda.device(rdm.device):
            g = self.graphs.get(key)
            if g is None:
                g = self.graphs[key] = _capture_tail(self, rdm, rdm_layout,
                                                     tail, maps_p)
            with span("cfar"):
                result = _replay_tail(g, rdm, maps_p)
        return None, None, None, None, result


def make_frame_stages(cfg: RadarConfig, precomp: Precomputed | None = None,
                      *, device, return_intermediates: bool = False,
                      trials: bool = False,
                      accelerator_dtypes: bool | None = None) -> FrameStages:
    """The frame's stages on ``device``; raises for a CUDA device without
    CUDA and for flag values the port does not know. The rank-K kernel
    routes take ``pipeline/lowrank.py::route_dtypes(cfg,
    accelerator_dtypes)``, by default the device's. ``trials``: the
    Monte-Carlo trial function's stages, whose tail, as JAX's
    ``make_trial_fn``'s, disregards ``kernel_maps``, ``beams_major_tail``
    and ``use_pallas_cfar`` (its K2 is kept where it gives the vgq tail's
    detections: shift means, no native scan)."""
    check_config(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for, but CUDA is not "
                           "available")
    if precomp is None:
        precomp = precompute(cfg)
    fused = cfg.fused_synth_dbf and not return_intermediates
    lowrank = cfg.lowrank_rdm and fused
    mc = measure_consts(cfg, precomp, device=device)
    # the debug taps read every stage of the tail: eager
    graphs = None if return_intermediates else {}
    if trials:
        tail, tfr = select_tail(
            cfg, lowrank, pallas_cfar=cfg.use_pallas_cfar
            and cfg.cfar.means_impl == "shift"
            and not cfg.extract_native_scan)
    else:
        tail, tfr = kernel_tail(cfg, lowrank), False
        if tail is None:
            tail, tfr = select_tail(cfg, lowrank,
                                    pallas_cfar=cfg.use_pallas_cfar,
                                    intermediates=return_intermediates)
    if lowrank:
        return FrameStages(cfg, mc,
                           make_lowrank_stages(
                               cfg, precomp, device=device,
                               accelerator_dtypes=accelerator_dtypes),
                           None, None, None, None, tail, tfr, graphs)
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
            noise = host_to_device(noise, device)
        if fused:
            if noise is not None and noise.shape != echo.shape:
                raise ValueError(f"the fused stream takes white beam noise "
                                 f"{tuple(echo.shape)}, got "
                                 f"{tuple(noise.shape)}")
            with span("noise"):
                if noise is None:
                    noise = white_complex_noise(
                        echo.shape, seeded_generator(frame_seed, device),
                        device=device)
                noisy, beams = None, add_noise_beamspace(echo, l_t, noise)
        else:
            if noise is not None and noise.shape != echo.shape:
                raise ValueError(f"the reference stream takes channel "
                                 f"AWGN {tuple(echo.shape)}, got "
                                 f"{tuple(noise.shape)}")
            with span("noise"):
                if noise is not None:
                    noisy = echo + noise.to(c64)
                elif kernel_noise and cfg.noise_impl == "pallas":
                    noisy = awgn(echo, seed_words(frame_seed))
                else:
                    noisy = add_noise(echo,
                                      seeded_generator(frame_seed, device))
            with span("dbf"):
                beams = dbf(noisy, precomp.dbf_w, cfg.dbf_variant)
        with span("pc"):
            pc = pc_stage(beams)
        with span("mtd"):
            rdm = mtd_stage(pc)
        return noisy, beams, pc, rdm

    def pc_stage(beams):
        if mplan is not None:
            return pulse_compress_matmul(beams, mplan, precision=prec)
        return pulse_compress(beams, precomp, pplan)

    def mtd_stage(pc):
        if mtd_t is not None:
            return mtd_matmul(pc, mtd_t, precision=prec)
        return mtd(pc, precomp.mtd_win, cfg.mtd_fft_len)          # [V, G, B]

    return FrameStages(cfg, mc, None, synth, chain, pc_stage, mtd_stage,
                       tail, tfr, graphs)


def make_frame_processor(cfg: RadarConfig,
                         precomp: Precomputed | None = None, *,
                         device="cuda", return_intermediates: bool = False,
                         accelerator_dtypes: bool | None = None):
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
    the rank-K stream's kernel routes. The wrong kind raises.
    ``accelerator_dtypes`` picks the kernel routes' dtypes
    (``pipeline/lowrank.py::route_dtypes``; by default the device's)."""
    st = make_frame_stages(cfg, precomp, device=device,
                           return_intermediates=return_intermediates,
                           accelerator_dtypes=accelerator_dtypes)
    lr = st.lowrank
    if lr is not None:
        def process(frame_seed: int, targets, noise=None,
                    noise_planes=None) -> FrameResult:
            maps_p = None
            if lr.impl == "pallas_prng":
                if noise is not None:
                    raise ValueError("the rank-K perf stream takes injected "
                                     "noise as noise_planes=")
                # the complete RDM from one K1 call (signal fused); on the
                # kernel-maps tail with its padded pair maps
                rdm = lr.noise_rdm_sig(frame_seed, targets, layout="bvg",
                                       planes=noise_planes,
                                       emit_maps=st.tail == "kernel_maps")
                if st.tail == "kernel_maps":
                    rdm, maps_p = rdm
            else:
                rdm = lr.noisy_rdm(lr.signal_rdm(targets, lr.rdm_layout),
                                   frame_seed, noise, noise_planes)
            return st.detect(rdm, lr.rdm_layout, maps_p)[-1]

        process.stages = lr
        return process

    def process(frame_seed: int, targets, noise=None, noise_planes=None):
        if noise_planes is not None:
            raise ValueError("noise_planes= drives the rank-K perf stream "
                             "only; this stream takes noise=")
        with span("synth"):
            echo = st.synth(targets)
        noisy, beams, pc, rdm = st.chain(echo, frame_seed, noise)
        pair_maps, dets, params, s1, result = st.detect(rdm, "vgb")
        if return_intermediates:
            return FrameIntermediates(
                raw_iq=noisy, beams=beams, pc=pc, rdm=rdm,
                pair_maps=pair_maps, detections=dets, params=params,
                stage1=s1, result=result)
        return result

    return process
